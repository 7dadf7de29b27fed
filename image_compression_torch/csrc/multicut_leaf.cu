// Multicut leaf: hierarchy levels 0-1 of the matrix-aggregation chain GAEC,
// CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel of the JAX reference package,
// ops/multicut_leaf.py::_leaf_kernel. The plain PyTorch version of the same
// function is leaf_plain in image_compression_torch/ops/multicut_leaf.py; on
// integer-valued costs the two agree bit for bit. The test
// tests/test_torch_leaf_source.py compiles this file for the CPU and holds
// it bitwise to leaf_plain.
//
// Design: one CTA of 128 threads per 16x16 supertile, all supertiles of a
// batch in one launch. Level 0 runs one warp per 8x8 child (64 slots, only
// __syncwarp between its steps); level 1 runs the whole CTA on s1 slots.
//
// The pair matrices of leaf_plain are sparse: an 8x8 child has 112 pixel
// edges and so at most 112 adjacent region pairs, a supertile 4 * 112 + 32.
// So the state is a pair list per child (128 entries) and per supertile (the
// same 512 entries), key A << 16 | B with A < B and the summed cost. A round:
//   1. best[A] = max over the pairs of A of (cost bits << 32 | 0xFFFF - B),
//      a 64-bit shared-memory atomicMax over pairs with cost > 0: the row
//      maximum with ties to the smallest partner, merging iff it is > 0,
//      which is the dense rule (dead and non-adjacent slots hold 0 there);
//   2. hook, break 2-cycles toward the smaller id, three pointer doublings;
//   3. m (smallest pixel id, f32 bits) by an integer atomicMin per target;
//   4. relabel the keys through the map, bitonic-sort them, sum each run of
//      equal keys in sorted order and compact the run heads (ranks from
//      __ballot_sync + __popc).
// Sums run in an order fixed by the sort network and the input, never by
// atomics, so outputs repeat bit for bit from run to run on real costs too.
// Dense ranks (the re-rank after the rounds) also come from ballots. The
// dense [s1, s1] matrix is written only at the end: a float4 zero fill of
// each supertile's block, then the pairs.
//
// What bounds it on an H100: per supertile ~3 KB in, ~2 KB + 4 * s1 * s1
// bytes out; for 2048 supertiles at s1 = 64 about 44 MB (~13 us at
// 3.35 TB/s), the 33.5 MB sym write most of it. The work is compares and
// adds on sparse graphs of at most 128 slots, latency-bound by the steps of
// the rounds and the sort networks, so the design keeps many supertiles in
// flight: ~15 KB of static shared memory per CTA (no dynamic shared memory)
// and at most 64 registers, for 8 or more resident supertiles per SM. No
// tensor cores: wgmma would bring back the O(S^3) one-hot products of the
// Pallas kernel. No TMA: each supertile reads ~3 KB once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int S0 = 64;            // level-0 slots: the pixels of an 8x8 child
constexpr int LIST0 = 128;        // pair entries of a child (112 edges + pad)
constexpr int LIST1 = 4 * LIST0;  // pair entries of a supertile
constexpr int MID0 = 120;         // child q's 8 mid-line edges sit at
                                  // q * LIST0 + MID0 ... (past its <= 112)
constexpr int THREADS = 128;      // one warp per child
constexpr int MAX_S1 = 128;       // largest level-1 slot cap
constexpr unsigned SENT = 0xFFFFFFFFu;  // empty list entry
constexpr unsigned FULL = 0xFFFFFFFFu;  // all lanes

struct Shared {
  unsigned key[LIST1];               // pair lists (child q: q * LIST0 ...)
  float val[LIST1];                  // summed pair costs
  unsigned long long best[4 * S0];   // packed (cost, partner) per slot
  int nxt[4 * S0];                   // merge map
  int tmp[4 * S0];
  unsigned m[4 * S0];                // smallest pixel id per slot (f32 bits)
  unsigned mnew[4 * S0];
  int lab[4 * S0];                   // level 0: pixel -> slot; level 1:
                                     // entry slot -> slot (cmap)
  int rank[4 * S0];                  // dense rank per slot
  int rank1[4 * S0];                 // pixel -> level-1 entry slot, -1 frozen
  unsigned m0c[4 * S0];              // each child's m after its re-rank
  int wcount[16];                    // compaction counts per chunk and warp
  int wsum[4];                       // alive slots per warp (level-1 rank)
  int nal[4];                        // live regions per child
  int count[4];                      // pair entries per child
};

template <int NT>
__device__ __forceinline__ void group_sync() {
  if (NT == 32)
    __syncwarp();
  else
    __syncthreads();
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// Bitonic sort of entries [0, n) by key (n a power of two, n/2 >= 1),
// carrying the values; called by all NT threads of the group.
template <int NT>
__device__ void bitonic(unsigned* key, float* val, int n, int t) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = t; x < n / 2; x += NT) {
        const int i = 2 * x - (x & (j - 1));  // bit j of i is clear
        const int l = i + j;
        const unsigned ki = key[i], kl = key[l];
        if ((ki > kl) == ((i & k) == 0)) {
          key[i] = kl;
          key[l] = ki;
          const float v = val[i];
          val[i] = val[l];
          val[l] = v;
        }
      }
      group_sync<NT>();
    }
  }
}

// Sort entries [0, pow2(n)), sum each run of equal keys in sorted order and
// write the run heads, in order, to the front; the rest of the sorted range
// becomes SENT. Entries past the range are SENT already. Returns the count.
template <int NT>
__device__ int dedup(unsigned* key, float* val, int n, int t, int* wcount) {
  constexpr int NW = NT / 32;
  const int size = pow2_at_least(n);  // <= 4 * NT
  bitonic<NT>(key, val, size, t);
  const int lane = t & 31, w = t / 32;
  unsigned hk[4], bal[4];
  float hv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int i = c * NT + t;
    bool head = false;
    hk[c] = SENT;
    hv[c] = 0.f;
    if (i < size) {
      const unsigned k = key[i];
      if (k != SENT && (i == 0 || key[i - 1] != k)) {
        float s = 0.f;
        for (int j = i; j < size && key[j] == k; ++j) s += val[j];
        head = true;
        hk[c] = k;
        hv[c] = s;
      }
    }
    bal[c] = __ballot_sync(FULL, head);
    if (lane == 0) wcount[c * NW + w] = __popc(bal[c]);
  }
  group_sync<NT>();  // every read above is done; the counts are visible
  int total = 0, pre[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    pre[c] = total;
    for (int ww = 0; ww < NW; ++ww) {
      const int cnt = wcount[c * NW + ww];
      if (ww < w) pre[c] += cnt;
      total += cnt;
    }
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (hk[c] != SENT) {
      const int pos = pre[c] + __popc(bal[c] & below);
      key[pos] = hk[c];
      val[pos] = hv[c];
    }
  }
  for (int i = total + t; i < size; i += NT) key[i] = SENT;
  group_sync<NT>();
  return total;
}

// One chain-mode round on a pair list over `slots` slots; `lab[0, n_lab)`
// is composed with the round's map. Returns the new entry count.
template <int NT>
__device__ int gaec_round(unsigned* key, float* val, int n, int slots,
                          unsigned long long* best, int* nxt, int* tmp,
                          unsigned* m, unsigned* mnew, int* lab, int n_lab,
                          unsigned sentinel, int t, int* wcount) {
  for (int s = t; s < slots; s += NT) best[s] = 0ull;
  group_sync<NT>();
  for (int i = t; i < n; i += NT) {
    const unsigned k = key[i];
    const float v = val[i];
    if (k != SENT && v > 0.f) {
      const unsigned long long hi = (unsigned long long)__float_as_uint(v)
                                    << 32;
      const unsigned a = k >> 16, b = k & 0xFFFFu;
      atomicMax(&best[a], hi | (0xFFFFu - b));
      atomicMax(&best[b], hi | (0xFFFFu - a));
    }
  }
  group_sync<NT>();
  for (int s = t; s < slots; s += NT) {
    const unsigned long long bk = best[s];
    nxt[s] = bk ? (int)(0xFFFFu - (unsigned)(bk & 0xFFFFFFFFull)) : s;
  }
  group_sync<NT>();
  for (int s = t; s < slots; s += NT) {  // break 2-cycles to the smaller id
    const int v = nxt[s];
    tmp[s] = (nxt[v] == s && s < v) ? s : v;
  }
  group_sync<NT>();
  // three pointer doublings contract the chains
  for (int s = t; s < slots; s += NT) nxt[s] = tmp[tmp[s]];
  group_sync<NT>();
  for (int s = t; s < slots; s += NT) tmp[s] = nxt[nxt[s]];
  group_sync<NT>();
  for (int s = t; s < slots; s += NT) {
    nxt[s] = tmp[tmp[s]];
    mnew[s] = sentinel;
  }
  group_sync<NT>();
  for (int s = t; s < slots; s += NT) atomicMin(&mnew[nxt[s]], m[s]);
  for (int i = t; i < n_lab; i += NT) lab[i] = nxt[lab[i]];
  for (int i = t; i < n; i += NT) {
    const unsigned k = key[i];
    if (k == SENT) continue;
    const int a = nxt[k >> 16], b = nxt[k & 0xFFFFu];
    key[i] = a == b ? SENT
                    : ((unsigned)min(a, b) << 16) | (unsigned)max(a, b);
  }
  group_sync<NT>();
  for (int s = t; s < slots; s += NT) m[s] = mnew[s];
  return dedup<NT>(key, val, n, t, wcount);  // syncs before it reads
}

__global__ void __launch_bounds__(THREADS, 8)
leaf_kernel(const float* __restrict__ w0h, const float* __restrict__ w0v,
            const float* __restrict__ wmid, const float* __restrict__ pix,
            int* __restrict__ rank_out, int* __restrict__ gid_out,
            float* __restrict__ sym_out, float* __restrict__ m_out,
            int* __restrict__ ncand_out, int* __restrict__ over_out, int s1,
            int r0, int r1, float sentinel_f) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int q = tid / 32;  // this warp's child (quad order 00, 01, 10, 11)
  const int lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  const unsigned sentinel = __float_as_uint(sentinel_f);
  const size_t tile = blockIdx.x;
  const size_t in0 = tile * 4 * S0;

  // ---- level 0: one warp per child --------------------------------------
  unsigned* key0 = sh.key + q * LIST0;
  float* val0 = sh.val + q * LIST0;
  unsigned* m0 = sh.m + q * S0;
  int* lab0 = sh.lab + q * S0;
  for (int p = lane; p < S0; p += 32) {
    // entry 2p: pixel p -- p+1; entry 2p+1: pixel p -- p+8
    const float wh = bf16_round(w0h[in0 + q * S0 + p]);
    const float wv = bf16_round(w0v[in0 + q * S0 + p]);
    const bool has_h = p % 8 != 7, has_v = p + 8 < S0;
    key0[2 * p] = has_h ? ((unsigned)p << 16) | (unsigned)(p + 1) : SENT;
    val0[2 * p] = has_h ? wh : 0.f;
    key0[2 * p + 1] = has_v ? ((unsigned)p << 16) | (unsigned)(p + 8) : SENT;
    val0[2 * p + 1] = has_v ? wv : 0.f;
    m0[p] = __float_as_uint(pix[in0 + q * S0 + p]);
    lab0[p] = p;
  }
  __syncwarp();
  int n0 = LIST0;
  for (int r = 0; r < r0; ++r)
    n0 = gaec_round<32>(key0, val0, n0, S0, sh.best + q * S0,
                        sh.nxt + q * S0, sh.tmp + q * S0, m0,
                        sh.mnew + q * S0, lab0, S0, sentinel, lane,
                        sh.wcount + 4 * q);
  if (r0 == 0) n0 = dedup<32>(key0, val0, n0, lane, sh.wcount + 4 * q);

  // dense re-rank of the live slots (ranks keep the order of the keys)
  int* rank0 = sh.rank + q * S0;
  unsigned* m0c = sh.m0c + q * S0;
  int nal = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int s = c * 32 + lane;
    const bool alive = m0[s] < sentinel;
    const unsigned b = __ballot_sync(FULL, alive);
    const int r = nal + __popc(b & below);
    rank0[s] = r;
    if (alive) m0c[r] = m0[s];
    nal += __popc(b);
  }
  for (int r = nal + lane; r < S0; r += 32) m0c[r] = sentinel;
  __syncwarp();
  for (int i = lane; i < n0; i += 32) {
    const unsigned k = key0[i];
    key0[i] = ((unsigned)rank0[k >> 16] << 16) | (unsigned)rank0[k & 0xFFFFu];
  }
  const int rp0 = rank0[lab0[lane]], rp1 = rank0[lab0[lane + 32]];
  if (lane == 0) {
    sh.nal[q] = nal;
    sh.count[q] = n0;
  }
  __syncthreads();

  // ---- level-1 transition: offsets, freeze, embed, mid-line edges -------
  const int off[4] = {0, sh.nal[0], sh.nal[0] + sh.nal[1],
                      sh.nal[0] + sh.nal[1] + sh.nal[2]};
  const int total0 = off[3] + sh.nal[3];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = lane + 32 * j;
    const int r = j ? rp1 : rp0;
    const int cand = r + off[q];
    const bool frozen = cand >= s1;
    gid_out[in0 + q * S0 + p] =
        frozen ? (int)__uint_as_float(m0c[r]) : 0;
    sh.rank1[q * S0 + p] = frozen ? -1 : cand;
  }
  for (int i = lane; i < sh.count[q]; i += 32) {
    const unsigned k = key0[i];
    const unsigned a = (k >> 16) + off[q], b = (k & 0xFFFFu) + off[q];
    key0[i] = b < (unsigned)s1 ? (a << 16) | b : SENT;
  }
  for (int s = tid; s < s1; s += THREADS) {
    unsigned v = sentinel;
    for (int qq = 0; qq < 4; ++qq)
      if (s >= off[qq] && s < off[qq] + sh.nal[qq])
        v = sh.m0c[qq * S0 + s - off[qq]];
    sh.m[s] = v;  // level-0 m is dead: level 1 reuses it
    sh.lab[s] = s;
  }
  __syncthreads();
  if (tid < 32) {
    // 16 horizontal edges (y, 7)-(y, 8), then 16 vertical (7, x)-(8, x);
    // endpoints sit in different children, so their ranks differ
    const int e = tid;
    int ia, ib;
    if (e < 16) {
      ia = ((e / 8) * 2) * S0 + (e % 8) * 8 + 7;
      ib = ((e / 8) * 2 + 1) * S0 + (e % 8) * 8;
    } else {
      const int x = e - 16;
      ia = (x / 8) * S0 + 56 + x % 8;
      ib = (2 + x / 8) * S0 + x % 8;
    }
    const int a = sh.rank1[ia], b = sh.rank1[ib];
    if (a >= 0 && b >= 0) {
      const int pos = (e / 8) * LIST0 + MID0 + e % 8;
      sh.key[pos] = ((unsigned)min(a, b) << 16) | (unsigned)max(a, b);
      sh.val[pos] = bf16_round(wmid[tile * 32 + e]);
    }
  }
  __syncthreads();

  // ---- level 1: the whole CTA on s1 slots --------------------------------
  int n1 = dedup<THREADS>(sh.key, sh.val, LIST1, tid, sh.wcount);
  for (int r = 0; r < r1; ++r)
    n1 = gaec_round<THREADS>(sh.key, sh.val, n1, s1, sh.best, sh.nxt,
                             sh.tmp, sh.m, sh.mnew, sh.lab, s1, sentinel,
                             tid, sh.wcount);
  __syncthreads();  // m of the last round is visible
  // dense re-rank: one slot per thread, ranks from ballots
  const bool alive = tid < s1 && sh.m[tid] < sentinel;  // s1 <= THREADS
  const unsigned b = __ballot_sync(FULL, alive);
  if (lane == 0) sh.wsum[q] = __popc(b);
  __syncthreads();
  int base = 0, n_alive = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    if (w < q) base += sh.wsum[w];
    n_alive += sh.wsum[w];
  }
  const int my_rank = base + __popc(b & below);
  float* m_tile = m_out + tile * s1;
  if (alive) {
    sh.rank[tid] = my_rank;
    m_tile[my_rank] = __uint_as_float(sh.m[tid]);
  }
  for (int k = n_alive + tid; k < s1; k += THREADS) m_tile[k] = sentinel_f;
  float* so = sym_out + tile * s1 * s1;
  const int nsym = s1 * s1;
  if (nsym % 4 == 0) {
    float4* so4 = reinterpret_cast<float4*>(so);
    for (int i = tid; i < nsym / 4; i += THREADS)
      so4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = tid; i < nsym; i += THREADS) so[i] = 0.f;
  }
  __syncthreads();  // ranks visible; the zero fill precedes the pairs
  for (int i = tid; i < n1; i += THREADS) {
    const unsigned k = sh.key[i];
    const int a = sh.rank[k >> 16], c = sh.rank[k & 0xFFFFu];
    so[a * s1 + c] = sh.val[i];
    so[c * s1 + a] = sh.val[i];
  }
  for (int p = tid; p < 4 * S0; p += THREADS) {
    const int r = sh.rank1[p];
    rank_out[in0 + p] = r < 0 ? -1 : sh.rank[sh.lab[r]];
  }
  if (tid == 0) {
    ncand_out[tile] = n_alive;
    over_out[tile] = total0 > s1 ? total0 - s1 : 0;
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
  leaf_kernel<<<t1, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)w0h, (const float*)w0v, (const float*)wmid,
      (const float*)pix, (int*)rank, (int*)gid, (float*)sym, (float*)m,
      (int*)ncand, (int*)over, s1, r0, r1, (float)n_pix);
  return (int)cudaGetLastError();
}

// Resident CTAs (= supertiles) per SM, as the CUDA runtime computes it for
// this card; -1 on error. Shared memory and registers do not depend on the
// level-1 cap, so one instance serves every s1.
extern "C" int multicut_leaf_resident(void) {
  int blocks = -1;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, leaf_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -1;
}
