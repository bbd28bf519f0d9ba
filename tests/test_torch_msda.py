"""The port's MSDA against the JAX package's three MSDA forwards and its
gradients against the JAX package's custom VJP.

`ms_deform_attn_plain` (the CPU path and the plain version of the CUDA
kernel) is held at 1e-5 abs in f32 against `ms_deform_attn_xla`,
`ms_deform_attn_xla_quad` and the Pallas kernel `ms_deform_attn_pallas`
itself, run in Pallas interpret mode on the CPU. Cases cover out-of-range
locations (zero padding), locations exactly on 0 and 1, B=2, odd level
sizes, D below a warp and the main path's own mapping (H=8, D=32, L=P=4) at a
Q whose items do not fill the kernel's last tile. The CUDA kernel is held
against the plain version on the card (`cuda` marker), in both its (L, P)
instantiations (L = P = 4 and the generic one) at every head dim it takes.
The gradients: `ms_deform_attn_backward_plain` (the plain version of the
CUDA backward kernel) and autograd through `ms_deform_attn_plain` (the CPU
path) against `jax.vjp` of `ms_deform_attn_quad` (the hand-written backward)
and of `ms_deform_attn_xla`, each gradient at 1e-5 of its own largest
magnitude in f32; on the card, `msda_backward` against the plain backward.
JAX is imported inside the tests that use it, so that the card tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_msda.py
"""

import functools
import types

import numpy as np
import pytest
import torch

from ziragroundingdino_torch.ops.msda import (
    ms_deform_attn,
    ms_deform_attn_backward_plain,
    ms_deform_attn_plain,
)
from ziragroundingdino_torch.ops.msda_cuda import msda_backward, msda_forward

ATOL = 1e-5

CASES = {
    # name: (B, Q, H, D, P, spatial_shapes, location range)
    "inside": (1, 16, 2, 8, 2, ((6, 5), (3, 3)), (0.0, 1.0)),
    "ragged_b2": (2, 21, 3, 16, 4, ((7, 9), (5, 3), (2, 11), (1, 1)), (-0.1, 1.1)),
    "far_out": (2, 9, 2, 4, 3, ((4, 4), (2, 3)), (-3.0, 4.0)),
    # the narrow D at L = P = 4, which the kernel instantiates apart
    "narrow_d4": (1, 11, 3, 4, 4, ((5, 7), (3, 4), (2, 2), (1, 3)), (-0.2, 1.2)),
    "narrow_d8": (1, 13, 2, 8, 4, ((4, 6), (2, 3), (1, 2), (1, 1)), (0.0, 1.0)),
    # the main path's mapping at an odd Q; a fifth of the coordinates each
    # exactly 0, exactly 1, far below 0 and far above 1, the rest in [0, 1]
    "main_tail": (2, 45, 8, 32, 4, ((10, 12), (5, 6), (3, 3), (2, 1)), "edges"),
    # the generic (L, P) instantiation at the wide head dims
    "generic_d32": (1, 19, 8, 32, 3, ((9, 7), (4, 5), (2, 3)), "edges"),
    "generic_d16": (2, 7, 2, 16, 2, ((3, 3), (2, 2), (1, 4), (1, 1), (2, 1)), (-0.5, 1.5)),
}
EDGES = (0.0, 1.0, -7.5, 8.25)


def _inputs(case, seed=0):
    b, q, h, d, p, shapes, span = CASES[case]
    rng = np.random.RandomState(seed)
    s = sum(hh * ww for hh, ww in shapes)
    n_levels = len(shapes)
    value = rng.randn(b, s, h, d).astype(np.float32)
    size = (b, q, h, n_levels, p, 2)
    if span == "edges":
        pick = rng.randint(0, len(EDGES) + 1, size)
        loc = np.where(pick < len(EDGES), np.take(EDGES + (0.0,), pick), rng.rand(*size))
        loc = loc.astype(np.float32)
    else:
        lo, hi = span
        loc = (lo + (hi - lo) * rng.rand(*size)).astype(np.float32)
    attn = rng.rand(b, q, h, n_levels, p).astype(np.float32)
    attn /= attn.sum(axis=(-2, -1), keepdims=True)
    return shapes, value, loc, attn


def _port(shapes, value, loc, attn):
    return ms_deform_attn_plain(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                                torch.from_numpy(attn), q_chunk=8).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("ref", ["xla", "xla_quad"])
def test_plain_matches_jax(case, ref):
    import jax
    import jax.numpy as jnp
    from ziragroundingdino_tpu.ops import msda as jmsda

    shapes, value, loc, attn = _inputs(case)
    fn = {"xla": jmsda.ms_deform_attn_xla, "xla_quad": jmsda.ms_deform_attn_xla_quad}[ref]
    want = np.asarray(jax.jit(fn, static_argnums=1)(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_port(shapes, value, loc, attn), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["ragged_b2", "far_out"])
def test_plain_matches_pallas_interpret(case, monkeypatch):
    """The TPU kernel itself, in Pallas interpret mode, without editing it."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from ziragroundingdino_tpu.ops import msda_pallas

    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl) if not n.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(msda_pallas, "pl", shim)
    shapes, value, loc, attn = _inputs(case)
    want = np.asarray(jax.jit(msda_pallas.ms_deform_attn_pallas, static_argnums=1)(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn)))
    np.testing.assert_allclose(_port(shapes, value, loc, attn), want, atol=ATOL, rtol=0)


def _grad_out(case, seed=1):
    b, q, h, d = CASES[case][:4]
    return np.random.RandomState(seed).randn(b, q, h * d).astype(np.float32)


def _port_grads(shapes, value, loc, attn, g):
    """(plain backward, autograd through the plain forward), each (d_value,
    d_loc, d_attn) as numpy."""
    t = [torch.from_numpy(x) for x in (value, loc, attn)]
    explicit = ms_deform_attn_backward_plain(*t[:1], shapes, *t[1:], torch.from_numpy(g),
                                             q_chunk=8)
    leaves = [x.clone().requires_grad_(True) for x in t]
    ms_deform_attn_plain(leaves[0], shapes, *leaves[1:], q_chunk=8).backward(
        torch.from_numpy(g))
    return [x.numpy() for x in explicit], [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    """d_value, d_loc and d_attn of the port (plain backward and autograd)
    against jax.vjp of `ms_deform_attn_quad` (custom VJP) and of
    `ms_deform_attn_xla` (autodiff), at 1e-5 times each gradient's largest
    magnitude: d_loc carries the level's width or height as a factor."""
    import jax
    import jax.numpy as jnp
    from ziragroundingdino_tpu.ops import msda as jmsda

    shapes, value, loc, attn = _inputs(case)
    g = _grad_out(case)
    explicit, autograd = _port_grads(shapes, value, loc, attn, g)
    for fn in (jmsda.ms_deform_attn_quad, jmsda.ms_deform_attn_xla):
        def pull(v, l_, a, g_, fn=fn):
            return jax.vjp(lambda *x: fn(x[0], shapes, *x[1:]), v, l_, a)[1](g_)

        want = [np.asarray(x) for x in jax.jit(pull)(*map(jnp.asarray, (value, loc, attn, g)))]
        for name, w, e, a in zip(("d_value", "d_loc", "d_attn"), want, explicit, autograd):
            tol = ATOL * max(np.abs(w).max(), 1e-30)
            for got, how in ((e, "plain backward"), (a, "autograd")):
                np.testing.assert_allclose(got, w, atol=tol, rtol=0,
                                           err_msg=f"{case} {fn.__name__} {name} {how}")


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
    g = torch.from_numpy(_grad_out("inside"))
    before = msda_backward.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        msda_backward(v.detach(), shapes, l_, a, g)
    with pytest.raises(ValueError, match="grad_out must be"):
        msda_backward(v.detach(), shapes, l_, a, g[:, 1:])
    assert msda_backward.launches == before


def _refused(case):
    """Inputs that the kernel does not take, built from the "inside" case."""
    shapes, value, loc, attn = _inputs("inside")
    v, l_, a = torch.from_numpy(value), torch.from_numpy(loc), torch.from_numpy(attn)
    if case == "head_dim":
        v = torch.zeros(*v.shape[:3], 64)
    elif case == "unaligned":
        v = torch.zeros(v.numel() + 1)[1:].view(v.shape)
    elif case == "too_many_samples":
        l_ = torch.zeros(*l_.shape[:4], 33, 2)
        a = torch.zeros(*a.shape[:4], 33)
    elif case == "samples_over_cap":
        l_ = torch.zeros(*l_.shape[:4], 16, 2)
        a = torch.zeros(*a.shape[:4], 16)
    elif case == "too_many_levels":
        shapes = ((1, 1),) * 9
        v = torch.zeros(v.shape[0], 9, *v.shape[2:])
        l_ = torch.zeros(*l_.shape[:3], 9, *l_.shape[4:])
        a = torch.zeros(*a.shape[:3], 9, a.shape[4])
    elif case == "attn_shape":
        a = a[..., :1].contiguous()
    elif case == "attn_dtype":
        a = a.double()
    return (v, shapes, l_, a)


@pytest.mark.parametrize("case, match", [
    ("head_dim", "head dim D=64"), ("unaligned", "16-byte aligned"),
    ("too_many_samples", "L\\*P=66"), ("samples_over_cap", "L\\*P=32 samples exceed 31"),
    ("too_many_levels", "9 spatial shapes"),
    ("attn_shape", "attention_weights must be"), ("attn_dtype", "must be float32")])
def test_cuda_wrapper_refuses_inputs_the_kernel_does_not_take(case, match):
    before = msda_forward.launches
    with pytest.raises(ValueError, match=match):
        msda_forward(*_refused(case))
    assert msda_forward.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda_device, dtype):
    """Every case. f32: 1e-5 of the output's scale (summation order); bf16:
    the kernel against the plain version in f32 on the same bf16 inputs,
    1e-2 relative (only the bf16 rounding of the output differs). Each call
    counts one launch."""
    dt = getattr(torch, dtype)
    for case in sorted(CASES):
        shapes, value, loc, attn = _inputs(case)
        v = torch.from_numpy(value).to(cuda_device, dt)
        l_ = torch.from_numpy(loc).to(cuda_device)
        a = torch.from_numpy(attn).to(cuda_device)
        before = msda_forward.launches
        got = msda_forward(v, shapes, l_, a).float()
        assert msda_forward.launches == before + 1
        want = ms_deform_attn_plain(v.float(), shapes, l_, a)
        scale = max(1.0, want.abs().max().item())
        tol = ATOL * scale if dt == torch.float32 else 1e-2 * scale
        assert (got - want).abs().max().item() <= tol, case


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_card(cuda_device, dtype):
    """Every case: `msda_backward` against `ms_deform_attn_backward_plain` on
    the same inputs (bf16: the plain backward in f32 on the bf16 inputs).
    f32: 1e-5 of each gradient's largest magnitude (summation order, and
    atomic adds in an order that varies); bf16: d_value 1e-2 of its scale
    (its one bf16 rounding), d_loc and d_attn 1e-4 (f32 outputs; the
    products with bf16 inputs are exact in f32). Each call counts one
    launch."""
    dt = getattr(torch, dtype)
    for case in sorted(CASES):
        shapes, value, loc, attn = _inputs(case)
        v = torch.from_numpy(value).to(cuda_device, dt)
        l_ = torch.from_numpy(loc).to(cuda_device)
        a = torch.from_numpy(attn).to(cuda_device)
        g = torch.from_numpy(_grad_out(case)).to(cuda_device, dt)
        before = msda_backward.launches
        got = msda_backward(v, shapes, l_, a, g)
        assert msda_backward.launches == before + 1
        want = ms_deform_attn_backward_plain(v.float(), shapes, l_, a, g.float())
        for name, x, w in zip(("d_value", "d_loc", "d_attn"), got, want):
            assert x.dtype == (dt if name == "d_value" else torch.float32), name
            scale = max(w.abs().max().item(), 1e-30)
            rel = ATOL if dt == torch.float32 else (1e-2 if name == "d_value" else 1e-4)
            err = (x.float() - w).abs().max().item()
            assert err <= rel * scale, (case, name, err, scale)


@pytest.mark.cuda
def test_autograd_on_card_launches_both_kernels(cuda_device):
    """On CUDA tensors, `ms_deform_attn` under autograd launches
    `msda_forward` once and `msda_backward` once, and its gradients are the
    plain backward's."""
    shapes, value, loc, attn = _inputs("main_tail")
    leaves = [torch.from_numpy(x).to(cuda_device).requires_grad_(True)
              for x in (value, loc, attn)]
    g = torch.from_numpy(_grad_out("main_tail")).to(cuda_device)
    fwd, bwd = msda_forward.launches, msda_backward.launches
    out = ms_deform_attn(leaves[0], shapes, *leaves[1:])
    out.backward(g)
    assert (msda_forward.launches - fwd, msda_backward.launches - bwd) == (1, 1)
    want = ms_deform_attn_backward_plain(*[x.detach() for x in leaves[:1]], shapes,
                                         *[x.detach() for x in leaves[1:]], g)
    for x, w in zip(leaves, want):
        assert (x.grad - w).abs().max().item() <= ATOL * max(w.abs().max().item(), 1e-30)
