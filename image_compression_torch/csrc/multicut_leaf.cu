// Multicut leaf: hierarchy levels 0-1 of the matrix-aggregation chain GAEC,
// CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel of the JAX reference package,
// ops/multicut_leaf.py::_leaf_kernel. The plain
// PyTorch version of the same function is leaf_plain in
// image_compression_torch/ops/multicut_leaf.py; on integer-valued costs the
// two agree bit for bit.
//
// Design: one CTA of 256 threads per 16x16 supertile; all supertiles of a
// batch in one launch. Level 0 runs the four 8x8 children at once, 64
// threads per child, each thread owning one row of its child's 64x64 pair
// matrix. Level 1 runs the whole CTA on the [s1, s1] matrix. Every matrix
// lives in dynamic shared memory with a padded row stride (S + 1), so the
// row scans of 32 threads hit 32 distinct banks. Device memory is touched
// only to read the inputs and write the level-1 state.
//
// The Pallas kernel contracts one-hot matrices on the MXU; here a slot map
// (the merge map of a round, or the dense re-rank) is applied by listing the
// members of each target slot in ascending order and summing them:
//   x[a][B]  = sum over b -> B of sym[a][b]    (thread per row a)
//   sym[A][B] = sum over a -> A of x[a][B]     (thread per column B)
// which is O(S^2) per map instead of O(S^3), deterministic, and exact on
// integer-valued weights. Weights are rounded to bf16 (nearest even) before
// they are summed in f32, as the reference does.
//
// What bounds it on an H100: per supertile ~3 KB in, ~2 KB + 4*s1*s1 bytes
// out; for 2048 supertiles at s1 = 64 about 44 MB (~13 us at 3.35 TB/s).
// The arithmetic is a few hundred thousand f32 adds and compares per
// supertile, of the same order at the f32 rate; the kernel is latency-bound
// by its many block-wide barriers at one CTA per SM (~145 KB of shared
// memory each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int S0 = 64;             // level-0 slots: the pixels of an 8x8 child
constexpr int LD0 = S0 + 1;        // padded row stride of the level-0 matrices
constexpr int MAX_S1 = 128;        // largest level-1 slot cap the CTA holds
constexpr int THREADS = 4 * S0;    // one thread per level-0 row of each child
constexpr int NVEC = 9;            // per-team slot vectors (see Team)
constexpr int MAT_WORDS = 4 * S0 * LD0;  // four child matrices; also holds
                                         // one [MAX_S1][MAX_S1 + 1] matrix
static_assert(MAX_S1 * (MAX_S1 + 1) <= MAT_WORDS, "level-1 matrix must fit");

constexpr int SMEM_WORDS = 2 * MAT_WORDS + 4 * NVEC * S0 + NVEC * MAX_S1
                           + 4 * S0 + 8;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_WORDS;

// A group of threads that owns one pair matrix and its slot vectors.
struct Team {
  float* sym;    // [S][ld] pair-cost matrix
  float* x;      // [S][ld] scratch
  float* m;      // [S] smallest pixel id per slot (sentinel: dead)
  float* mtmp;   // [S]
  int* nxt;      // [S] merge map
  int* tmp;      // [S]
  int* cmap;     // [S] entry rank -> current rank
  int* cnt;      // [S] members per target slot
  int* start;    // [S] first member per target slot
  int* mem;      // [S] members, grouped by target slot
  int* rank;     // [S] dense re-rank (inclusive live count - 1)
  int S, ld, t, nt;  // slots, row stride, thread index in team, team size
};

__device__ Team make_team(float* sym, float* x, float* vec, int S, int ld,
                          int t, int nt) {
  Team tm;
  tm.sym = sym;
  tm.x = x;
  tm.m = vec;
  tm.mtmp = vec + S;
  int* iv = reinterpret_cast<int*>(vec + 2 * S);
  tm.nxt = iv;
  tm.tmp = iv + S;
  tm.cmap = iv + 2 * S;
  tm.cnt = iv + 3 * S;
  tm.start = iv + 4 * S;
  tm.mem = iv + 5 * S;
  tm.rank = iv + 6 * S;
  tm.S = S;
  tm.ld = ld;
  tm.t = t;
  tm.nt = nt;
  return tm;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Aggregate sym and m through the slot map `map` (values in [-1, S); -1
// drops the slot): sym'[A][B] = sum over a -> A, b -> B of sym[a][b] and
// m'[A] = min over a -> A of m[a] (sentinel if A has no member). Called by
// every thread of the block.
__device__ void remap(const Team& tm, const int* map, bool zero_diag,
                      float sentinel) {
  const int S = tm.S, ld = tm.ld;
  for (int A = tm.t; A < S; A += tm.nt) {
    int c = 0;
    for (int a = 0; a < S; ++a) c += (map[a] == A);
    tm.cnt[A] = c;
  }
  __syncthreads();
  if (tm.t == 0) {
    int acc = 0;
    for (int A = 0; A < S; ++A) {
      tm.start[A] = acc;
      acc += tm.cnt[A];
    }
  }
  __syncthreads();
  for (int A = tm.t; A < S; A += tm.nt) {
    int pos = tm.start[A];
    for (int a = 0; a < S; ++a)
      if (map[a] == A) tm.mem[pos++] = a;
  }
  __syncthreads();
  for (int a = tm.t; a < S; a += tm.nt) {
    const float* row = tm.sym + a * ld;
    for (int B = 0; B < S; ++B) {
      float s = 0.f;
      const int end = tm.start[B] + tm.cnt[B];
      for (int j = tm.start[B]; j < end; ++j) s += row[tm.mem[j]];
      tm.x[a * ld + B] = s;
    }
  }
  for (int A = tm.t; A < S; A += tm.nt) {
    float v = sentinel;
    const int end = tm.start[A] + tm.cnt[A];
    for (int j = tm.start[A]; j < end; ++j) v = fminf(v, tm.m[tm.mem[j]]);
    tm.mtmp[A] = v;
  }
  __syncthreads();
  for (int B = tm.t; B < S; B += tm.nt) {
    for (int A = 0; A < S; ++A) {
      float s = 0.f;
      const int end = tm.start[A] + tm.cnt[A];
      for (int j = tm.start[A]; j < end; ++j) s += tm.x[tm.mem[j] * ld + B];
      tm.sym[A * ld + B] = (zero_diag && A == B) ? 0.f : s;
    }
  }
  for (int A = tm.t; A < S; A += tm.nt) tm.m[A] = tm.mtmp[A];
  __syncthreads();
}

// `rounds` chain-mode GAEC rounds, then the dense re-rank of the live slots.
// cmap starts as the identity; *n_alive receives the live slot count.
__device__ void gaec_rounds(const Team& tm, int rounds, float sentinel,
                            int* n_alive) {
  const int S = tm.S, ld = tm.ld;
  for (int i = tm.t; i < S; i += tm.nt) tm.cmap[i] = i;
  for (int r = 0; r < rounds; ++r) {
    // hook each slot to its most attractive partner (first index of the
    // row maximum) when that is attractive
    for (int a = tm.t; a < S; a += tm.nt) {
      const float* row = tm.sym + a * ld;
      float best = row[0];
      int arg = 0;
      for (int b = 1; b < S; ++b) {
        const float v = row[b];
        if (v > best) {
          best = v;
          arg = b;
        }
      }
      tm.nxt[a] = best > 0.f ? arg : a;
    }
    __syncthreads();
    // break 2-cycles toward the smaller id
    for (int a = tm.t; a < S; a += tm.nt) {
      const int v = tm.nxt[a];
      tm.tmp[a] = (tm.nxt[v] == a && a < v) ? a : v;
    }
    __syncthreads();
    // three pointer doublings contract the chains
    for (int a = tm.t; a < S; a += tm.nt) tm.nxt[a] = tm.tmp[tm.tmp[a]];
    __syncthreads();
    for (int a = tm.t; a < S; a += tm.nt) tm.tmp[a] = tm.nxt[tm.nxt[a]];
    __syncthreads();
    for (int a = tm.t; a < S; a += tm.nt) tm.nxt[a] = tm.tmp[tm.tmp[a]];
    __syncthreads();
    remap(tm, tm.nxt, true, sentinel);
    for (int i = tm.t; i < S; i += tm.nt) tm.cmap[i] = tm.nxt[tm.cmap[i]];
    __syncthreads();  // nxt is rewritten by the next round
  }
  __syncthreads();
  // live iff it carries a finite smallest pixel id
  if (tm.t == 0) {
    int c = 0;
    for (int a = 0; a < S; ++a) {
      c += tm.m[a] < sentinel;
      tm.rank[a] = c - 1;
    }
    *n_alive = c;
  }
  __syncthreads();
  for (int a = tm.t; a < S; a += tm.nt)
    tm.tmp[a] = tm.m[a] < sentinel ? tm.rank[a] : -1;
  __syncthreads();
  remap(tm, tm.tmp, false, sentinel);
  for (int i = tm.t; i < S; i += tm.nt) {
    const int c = tm.cmap[i];
    tm.cmap[i] = (c >= 0 && c < S) ? tm.rank[c] : 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
leaf_kernel(const float* __restrict__ w0h, const float* __restrict__ w0v,
            const float* __restrict__ wmid, const float* __restrict__ pix,
            int* __restrict__ rank_out, int* __restrict__ gid_out,
            float* __restrict__ sym_out, float* __restrict__ m_out,
            int* __restrict__ ncand_out, int* __restrict__ over_out, int s1,
            int r0, int r1, float sentinel) {
  extern __shared__ float smem[];
  float* mat_a = smem;                       // child matrices, then level-1 x
  float* mat_b = mat_a + MAT_WORDS;          // child x, then level-1 matrix
  float* vec0 = mat_b + MAT_WORDS;           // 4 children x NVEC x S0
  float* vec1 = vec0 + 4 * NVEC * S0;        // NVEC x MAX_S1
  int* rank1 = reinterpret_cast<int*>(vec1 + NVEC * MAX_S1);  // [4][S0]
  int* nal = rank1 + 4 * S0;                 // [0..3] children, [4] level 1

  const int tid = threadIdx.x;
  const int q = tid / S0;  // this thread's child (quad order 00, 01, 10, 11)
  const int p = tid % S0;  // its row / pixel within the child
  const size_t in0 = (size_t)blockIdx.x * 4 * S0;

  // ---- level 0: band-structured pair matrix of each child ---------------
  const Team c = make_team(mat_a + q * S0 * LD0, mat_b + q * S0 * LD0,
                           vec0 + q * NVEC * S0, S0, LD0, p, S0);
  for (int b = 0; b < S0; ++b) c.sym[p * LD0 + b] = 0.f;
  __syncthreads();
  {
    const float wh = bf16_round(w0h[in0 + q * S0 + p]);  // pixel p -- p+1
    const float wv = bf16_round(w0v[in0 + q * S0 + p]);  // pixel p -- p+8
    if (p % 8 != 7) {
      c.sym[p * LD0 + p + 1] = wh;
      c.sym[(p + 1) * LD0 + p] = wh;
    }
    if (p + 8 < S0) {
      c.sym[p * LD0 + p + 8] = wv;
      c.sym[(p + 8) * LD0 + p] = wv;
    }
    c.m[p] = pix[in0 + q * S0 + p];
  }
  __syncthreads();
  gaec_rounds(c, r0, sentinel, &nal[q]);

  // ---- level-1 transition: offsets, freeze, embed, mid-line edges -------
  const int off_q = (q > 0 ? nal[0] : 0) + (q > 1 ? nal[1] : 0)
                    + (q > 2 ? nal[2] : 0);
  {
    const int r = c.cmap[p];  // pixel p's level-0 rank
    const int cand = r + off_q;
    const bool frozen = cand >= s1;
    gid_out[in0 + q * S0 + p] = frozen ? (int)c.m[r] : 0;
    rank1[q * S0 + p] = frozen ? -1 : cand;
  }
  const int ld1 = s1 + 1;
  const Team L = make_team(mat_b, mat_a, vec1, s1, ld1, tid, THREADS);
  for (int i = tid; i < s1 * ld1; i += THREADS) L.sym[i] = 0.f;
  for (int i = tid; i < s1; i += THREADS) L.m[i] = sentinel;
  __syncthreads();
  // the live block of each child lands at its rank offset (dead child
  // slots carry zero rows and the sentinel, so skipping them is exact)
  for (int qq = 0; qq < 4; ++qq) {
    const int n = nal[qq];
    const int off = (qq > 0 ? nal[0] : 0) + (qq > 1 ? nal[1] : 0)
                    + (qq > 2 ? nal[2] : 0);
    const float* src = mat_a + qq * S0 * LD0;
    const float* msrc = vec0 + qq * NVEC * S0;
    for (int i = tid; i < n * n; i += THREADS) {
      const int a = i / n, b = i % n;
      if (off + a < s1 && off + b < s1)
        L.sym[(off + a) * ld1 + off + b] = src[a * LD0 + b];
    }
    for (int a = tid; a < n; a += THREADS)
      if (off + a < s1) L.m[off + a] = msrc[a];
  }
  __syncthreads();
  if (tid == 0) {
    // 16 horizontal edges (y, 7)-(y, 8), then 16 vertical (7, x)-(8, x);
    // endpoints sit in different children, so a != b
    for (int e = 0; e < 32; ++e) {
      int ia, ib;
      if (e < 16) {
        ia = ((e / 8) * 2) * S0 + (e % 8) * 8 + 7;
        ib = ((e / 8) * 2 + 1) * S0 + (e % 8) * 8;
      } else {
        const int x = e - 16;
        ia = (x / 8) * S0 + 56 + x % 8;
        ib = (2 + x / 8) * S0 + x % 8;
      }
      const int A = rank1[ia], B = rank1[ib];
      if (A >= 0 && B >= 0) {
        const float w = bf16_round(wmid[(size_t)blockIdx.x * 32 + e]);
        L.sym[A * ld1 + B] += w;
        L.sym[B * ld1 + A] += w;
      }
    }
  }
  __syncthreads();

  // ---- level-1 rounds, compaction, pixel remap ---------------------------
  gaec_rounds(L, r1, sentinel, &nal[4]);
  {
    const int r = rank1[q * S0 + p];
    rank_out[in0 + q * S0 + p] = r < 0 ? -1 : L.cmap[r];
  }
  float* so = sym_out + (size_t)blockIdx.x * s1 * s1;
  for (int i = tid; i < s1 * s1; i += THREADS)
    so[i] = L.sym[(i / s1) * ld1 + i % s1];
  for (int i = tid; i < s1; i += THREADS)
    m_out[(size_t)blockIdx.x * s1 + i] = L.m[i];
  if (tid == 0) {
    ncand_out[blockIdx.x] = nal[4];
    const int total = nal[0] + nal[1] + nal[2] + nal[3];
    over_out[blockIdx.x] = total > s1 ? total - s1 : 0;
  }
}

}  // namespace

// Launch over t1 supertiles on `stream`. Inputs: w0h, w0v, pix [t1, 4, 64]
// f32 (child-major), wmid [t1, 32] f32. Outputs: rank, gid [t1, 4, 64] i32,
// sym [t1, s1, s1] f32, m [t1, s1] f32, ncand, over [t1] i32. n_pix = H*W is
// the min-pixel sentinel. Returns the cudaError_t of the launch.
extern "C" int multicut_leaf_launch(const void* w0h, const void* w0v,
                                    const void* wmid, const void* pix,
                                    void* rank, void* gid, void* sym, void* m,
                                    void* ncand, void* over, int t1, int s1,
                                    int r0, int r1, int n_pix, void* stream) {
  if (t1 < 0 || s1 < 1 || s1 > MAX_S1 || r0 < 0 || r1 < 0)
    return (int)cudaErrorInvalidValue;
  if (t1 == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  leaf_kernel<<<t1, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)w0h, (const float*)w0v, (const float*)wmid,
      (const float*)pix, (int*)rank, (int*)gid, (float*)sym, (float*)m,
      (int*)ncand, (int*)over, s1, r0, r1, (float)n_pix);
  return (int)cudaGetLastError();
}
