"""The port's MSDA against the JAX package's three MSDA forwards.

`ms_deform_attn_plain` (the CPU path and the plain version of the CUDA
kernel) is held at 1e-5 abs in f32 against `ms_deform_attn_xla`,
`ms_deform_attn_xla_quad` and the Pallas kernel `ms_deform_attn_pallas`
itself, run in Pallas interpret mode on the CPU. Cases cover out-of-range
locations (zero padding), B=2, odd level sizes and D below a warp. The CUDA
kernel is held against the plain version on the card (`cuda` marker).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ziragroundingdino_tpu.ops import msda as jmsda
from ziragroundingdino_tpu.ops import msda_pallas
from ziragroundingdino_torch.ops.msda import ms_deform_attn, ms_deform_attn_plain
from ziragroundingdino_torch.ops.msda_cuda import msda_forward

ATOL = 1e-5

CASES = {
    # name: (B, Q, H, D, P, spatial_shapes, location range)
    "inside": (1, 16, 2, 8, 2, ((6, 5), (3, 3)), (0.0, 1.0)),
    "ragged_b2": (2, 21, 3, 16, 4, ((7, 9), (5, 3), (2, 11), (1, 1)), (-0.1, 1.1)),
    "far_out": (2, 9, 2, 4, 3, ((4, 4), (2, 3)), (-3.0, 4.0)),
}


def _inputs(case, seed=0):
    b, q, h, d, p, shapes, (lo, hi) = CASES[case]
    rng = np.random.RandomState(seed)
    s = sum(hh * ww for hh, ww in shapes)
    n_levels = len(shapes)
    value = rng.randn(b, s, h, d).astype(np.float32)
    loc = (lo + (hi - lo) * rng.rand(b, q, h, n_levels, p, 2)).astype(np.float32)
    attn = rng.rand(b, q, h, n_levels, p).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return shapes, value, loc, attn


def _port(shapes, value, loc, attn):
    return ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                torch.from_numpy(attn), q_chunk=8).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ref", ["xla", "xla_quad"])
def test_plain_matches_jax(case, ref):
    shapes, value, loc, attn = _inputs(case)
    fn = {"xla": jmsda.ms_deform_attn_xla, "xla_quad": jmsda.ms_deform_attn_xla_quad}[ref]
    want = np.asarray(jax.jit(fn, static_argnums=1)(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_port(shapes, value, loc, attn), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["ragged_b2", "far_out"])
def test_plain_matches_pallas_interpret(case, monkeypatch):
    """The TPU kernel itself, in Pallas interpret mode, without editing it."""
    from jax.experimental import pallas as pl

    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(msda_pallas, "pl", shim)
    shapes, value, loc, attn = _inputs(case)
    want = np.asarray(jax.jit(msda_pallas.ms_deform_attn_pallas, static_argnums=1)(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_port(shapes, value, loc, attn), want, atol=ATOL, rtol=0)


def test_dispatch_and_chunking():
    """CPU tensors take the plain version; the Q chunk size changes nothing;
    bf16 value gives a bf16 output."""
    shapes, value, loc, attn = _inputs("ragged_b2")
    v, l_, a = torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn)
    full = ms_deform_attn_plain(v, shapes, l_, a, q_chunk=1024)
    np.testing.assert_array_equal(ms_deform_attn(v, shapes, l_, a).numpy(), full.numpy())
    np.testing.assert_allclose(_port(shapes, value, loc, attn), full.numpy(), atol=1e-6, rtol=0)
    out16 = ms_deform_attn(v.bfloat16(), shapes, l_, a)
    assert out16.dtype == torch.bfloat16 and out16.shape == full.shape
    with pytest.raises(ValueError):
        ms_deform_attn(v.to("meta"), shapes, l_.to("meta"), a.to("meta"))


def test_cuda_wrapper_refuses_what_it_cannot_run():
    shapes, value, loc, attn = _inputs("inside")
    v, l_, a = torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn)
    before = msda_forward.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        msda_forward(v, shapes, l_, a)
    with pytest.raises(ValueError, match="requires grad"):
        msda_forward(v.requires_grad_(True), shapes, l_, a)
    assert msda_forward.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """f32: 1e-5 of the output's scale (summation order); bf16: the kernel
    against the plain version in f32 on the same bf16 inputs, 1e-2 relative
    (only the bf16 rounding of the output differs)."""
    dt = getattr(torch, dtype)
    for case in sorted(CASES):
        shapes, value, loc, attn = _inputs(case)
        v = torch.from_numpy(value).to(cuda_device, dt)
        l_ = torch.from_numpy(loc).to(cuda_device)
        a = torch.from_numpy(attn).to(cuda_device)
        got = msda_forward(v, shapes, l_, a).float()
        want = ms_deform_attn_plain(v.float(), shapes, l_, a)
        scale = max(1.0, want.abs().max().item())
        tol = ATOL * scale if dt == torch.float32 else 1e-2 * scale
        assert (got - want).abs().max().item() <= tol, case
