"""K3's plain version against the Pallas weight-streaming probe it replaces.

The Pallas body below is restated from benchmarks/pallas_bw_probe.py:73-97 at
git 4565532 (the file is no longer in the tree) and runs with
`interpret=True` on the CPU. Same numpy inputs on both sides: x [1, I] bf16,
w [L, I, O] int8. The int8 values are exact in bf16 and every product is
exact in f32, so only the order of the f32 sums differs: tolerance 1e-5
relative to the largest output."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from faster_qwen3_tts_tpu_torch.ops import weight_stream as ws

torch.set_num_threads(1)


def _pallas_stream(x, w, BI):
    """The probe's `kern` and `pallas_call` (git 4565532), TPU compiler
    params left out: grid (L, I / BI), one [BI, O] int8 block of layer l per
    step, accumulated into the [1, O] f32 output."""
    L, I, O = w.shape

    def kern(x_ref, w_ref, o_ref):
        li = pl.program_id(0)
        ii = pl.program_id(1)

        @pl.when(jnp.logical_and(li == 0, ii == 0))
        def _():
            o_ref[...] = jnp.zeros_like(o_ref)

        wb = w_ref[0].astype(jnp.bfloat16)  # [BI, O]
        o_ref[...] += jax.lax.dot_general(
            x_ref[...], wb, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    return pl.pallas_call(
        kern,
        grid=(L, I // BI),
        in_specs=[
            pl.BlockSpec((1, BI), lambda l, i: (0, i)),
            pl.BlockSpec((1, BI, O), lambda l, i: (l, i, 0)),
        ],
        out_specs=pl.BlockSpec((1, O), lambda l, i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, O), jnp.float32),
        interpret=True,
    )(x, w)


def _inputs(L, I, O, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 127, (L, I, O), dtype=np.int8)
    x = (rng.standard_normal((1, I)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("L, I, O, BI", [(3, 64, 256, 32), (2, 96, 128, 32)])
def test_plain_matches_pallas_probe(L, I, O, BI):
    x, w = _inputs(L, I, O, seed=L)
    ref = np.asarray(_pallas_stream(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), BI))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = ws.weight_stream(xt, torch.from_numpy(w))
    assert out.shape == (1, O) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_cpu_tensor_takes_the_plain_version_without_a_launch():
    x, w = _inputs(2, 32, 64, seed=0)
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w)
    before = ws.weight_stream.launches
    out = ws.weight_stream(xt, wt)
    assert ws.weight_stream.launches == before
    torch.testing.assert_close(out, ws.weight_stream_plain(xt, wt), rtol=0, atol=0)
