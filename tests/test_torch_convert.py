"""The flax -> torch converter on the shipped flagship checkpoint
(artifacts/fcn_pretrained_r4_mixed_params), restored through the JAX
package: the converted f32 EdgeUNet matches the flax model at 32x32 within
1e-5 x max |output|."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from image_compression_tpu.models.unet import EdgeUNet as JUNet
from image_compression_tpu.train.checkpoint import load_params
from image_compression_torch.models.convert import state_dict_from_flax
from image_compression_torch.models.unet import EdgeUNet

torch.set_num_threads(1)

CKPT = (pathlib.Path(__file__).resolve().parent.parent / "artifacts"
        / "fcn_pretrained_r4_mixed_params")


def test_flagship_checkpoint_converts():
    template = jax.jit(JUNet().init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 32, 32, 3)))
    params = jax.tree.map(np.asarray, load_params(CKPT, template))
    sd = state_dict_from_flax(params)
    assert len(sd) == len(jax.tree.leaves(params)) == 64
    model = EdgeUNet(dtype=torch.float32)
    model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).random((1, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(JUNet(dtype=jnp.float32).apply)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
