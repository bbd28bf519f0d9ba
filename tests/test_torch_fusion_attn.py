"""The fusion layers' attention core (`ops/fusion_attn.py`): its plain version
against `BiMultiHeadAttention`'s inline path and the JAX package's fusion,
the split-KV arithmetic of the kernel's text->image pass against the
one-pass softmax, the routing of `BiMultiHeadAttention.forward`, the
wrapper's refusals, and on the card (`cuda` marker) the kernel against the
plain version, under the module and under graph capture. JAX is imported
inside the test that uses it, so that the card tests run where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_fusion_attn.py
"""

import types

import numpy as np
import pytest
import torch

from ziragroundingdino_torch.models import fusion
from ziragroundingdino_torch.models.fusion import BiMultiHeadAttention
from ziragroundingdino_torch.models.layers import NEG_INF
from ziragroundingdino_torch.ops import fusion_attn
from ziragroundingdino_torch.ops.fusion_attn import (
    fusion_attention,
    fusion_attention_cuda,
    fusion_attention_plain,
    split_plan,
)

ATOL = 1e-5

# name: (B, Nv, Nl, heads, hd, mask_v, mask_l); a mask "part" drops a seeded
# third of the keys, "row" drops every text token of item 1 as well
CASES = {
    "b2_ragged_nl": (2, 157, 45, 2, 32, "part", "part"),
    "text_row_masked": (2, 70, 32, 2, 32, "part", "row"),
    "b1_nl64": (1, 100, 64, 2, 32, None, "part"),
    "b1_nl256": (1, 65, 256, 2, 32, "part", "part"),
    "no_masks": (2, 33, 32, 2, 32, None, None),
}


def _module(case, dtype=torch.float32, dropout=0.0, seed=0):
    b, nv, nl, heads, hd, _, _ = CASES[case]
    e = heads * hd
    m = BiMultiHeadAttention(48, 40, e, heads, compute_dtype=dtype, dropout=dropout)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return m


def _inputs(case, seed=1):
    b, nv, nl, _, _, mv, ml = CASES[case]
    rng = np.random.RandomState(seed)
    v = torch.from_numpy(rng.randn(b, nv, 48).astype(np.float32))
    l_ = torch.from_numpy(rng.randn(b, nl, 40).astype(np.float32))
    mask_v = None if mv is None else torch.from_numpy(rng.rand(b, nv) > 0.3)
    mask_l = None if ml is None else torch.from_numpy(rng.rand(b, nl) > 0.3)
    if ml == "row":
        mask_l[1] = False
    return v, l_, mask_v, mask_l


def _plain_through(m, v, l_, mask_v, mask_l):
    """The module's projections, the plain core, the module's output
    projections."""
    h = m.num_heads
    hd = m.embed_dim // h
    out_v, out_l = fusion_attention_plain(m.v_proj(v) * hd ** -0.5, m.l_proj(l_),
                                          m.values_v_proj(v), m.values_l_proj(l_),
                                          mask_v, mask_l, h)
    return m.out_v_proj(out_v), m.out_l_proj(out_l)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_the_inline_path(case):
    """f32: the plain core through the module's projections against the
    module's inline path (grad on), which computed the same function."""
    m = _module(case)
    v, l_, mask_v, mask_l = _inputs(case)
    want = m(v, l_, mask_v, mask_l)
    with torch.no_grad():
        got = _plain_through(m, v, l_, mask_v, mask_l)
    for g_, w_, what in zip(got, want, ("out_v", "out_l")):
        scale = max(1.0, w_.abs().max().item())
        assert (g_ - w_).abs().max().item() <= ATOL * scale, (case, what)


@pytest.mark.parametrize("case", ["b2_ragged_nl", "text_row_masked"])
def test_plain_matches_jax_fusion(case):
    """f32: the plain core through the module's projections against the JAX
    package's `BiMultiHeadAttention` with the same weights."""
    import jax
    import jax.numpy as jnp

    from ziragroundingdino_tpu.models import fusion as jfusion

    b, nv, nl, heads, hd, _, _ = CASES[case]
    m = _module(case)
    v, l_, mask_v, mask_l = _inputs(case)
    params = {name: {"kernel": jnp.asarray(getattr(m, name).weight.detach().numpy().T),
                     "bias": jnp.asarray(getattr(m, name).bias.detach().numpy())}
              for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj",
                           "out_v_proj", "out_l_proj")}
    jm = jfusion.BiMultiHeadAttention(v_dim=48, l_dim=40, embed_dim=heads * hd,
                                      num_heads=heads, dtype=jnp.float32)
    want = jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(
        params, jnp.asarray(v.numpy()), jnp.asarray(l_.numpy()),
        jnp.asarray(mask_v.numpy()), jnp.asarray(mask_l.numpy()))
    with torch.no_grad():
        got = _plain_through(m, v, l_, mask_v, mask_l)
    for g_, w_, what in zip(got, want, ("out_v", "out_l")):
        w_ = torch.from_numpy(np.array(w_))
        assert (g_ - w_).abs().max().item() <= 1e-4 * max(1.0, w_.abs().max().item()), what


def _split_softmax(s, val, nl_rows_tiles, heads=1, b=1):
    """The text->image pass's arithmetic at one (b, h): the keys (columns of
    s [Nq, Nk]) cut as `split_plan` cuts them, each split walked in chunks
    of CHUNK_KEYS with an online max and sum and an unnormalised f32 output,
    then the splits rescaled by exp(m_s - M) and summed."""
    nq, nk = s.shape
    splits, per = split_plan(b, heads, nl_rows_tiles, nk)
    parts = []
    for sp in range(splits):
        m = torch.full((nq,), -float("inf"))
        l_ = torch.zeros(nq)
        o = torch.zeros(nq, val.shape[1])
        for c0 in range(sp * per, min(nk, (sp + 1) * per), fusion_attn.CHUNK_KEYS):
            x = s[:, c0:min(nk, sp * per + per, c0 + fusion_attn.CHUNK_KEYS)]
            m_new = torch.maximum(m, x.max(1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[:, None])
            l_ = l_ * alpha + p.sum(1)
            o = o * alpha[:, None] + p @ val[c0:c0 + x.shape[1]]
            m = m_new
        parts.append((m, l_, o))
    top = torch.stack([p[0] for p in parts]).max(0).values
    w = [torch.exp(p[0] - top) for p in parts]
    total = sum(wi * p[1] for wi, p in zip(w, parts))
    return sum(wi[:, None] * p[2] for wi, p in zip(w, parts)) / total[:, None], splits


# 89523: the image rows of five levels at 800x1344 (MM-Grounding-DINO-L)
@pytest.mark.parametrize("nk,nl", [(1000, 32), (20197, 256), (700, 64), (130, 256),
                                   (89523, 32)])
def test_split_combine_matches_one_pass_softmax(nk, nl):
    """Uneven splits (the last one short), masked keys at NEG_INF and one
    row whose keys are all masked (it averages them all)."""
    g = torch.Generator().manual_seed(nk)
    s = 4.0 * torch.randn(8, nk, generator=g, dtype=torch.float64).float()
    masked = torch.rand(nk, generator=g) < 0.3
    s[:, masked] = NEG_INF
    s[3] = NEG_INF
    val = torch.randn(nk, 16, generator=g)
    got, splits = _split_softmax(s, val, nl)
    want = torch.softmax(s.double(), 1) @ val.double()
    assert splits > 1 and (got.double() - want).abs().max().item() <= 1e-5
    assert torch.allclose(got[3].double(), val.double().mean(0), atol=1e-5)


@pytest.mark.parametrize("b,heads,nl,nv", [(2, 4, 256, 20197), (1, 4, 32, 20197),
                                           (1, 4, 64, 21504), (8, 4, 256, 20197),
                                           (1, 2, 45, 65), (2, 2, 32, 1),
                                           (1, 4, 32, 89523), (1, 4, 64, 80997)])
def test_split_plan_covers_every_key_once(b, heads, nl, nv):
    splits, per = split_plan(b, heads, nl, nv)
    assert per % fusion_attn.CHUNK_KEYS == 0 and splits * per >= nv > (splits - 1) * per
    tiles = b * heads * -(-nl // fusion_attn.BLOCK_ROWS)
    assert splits == 1 or tiles * splits <= fusion_attn.TARGET_BLOCKS  # one wave


class _Counting:
    """A stand-in for `fusion_attention` in the fusion module that counts
    its calls and runs the real one."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return fusion_attention(*args)


def test_routing(monkeypatch):
    """bf16 inference on a CPU tensor takes the plain core (not the kernel:
    its launch counter stays); grad on, a token shard, an active dropout
    generator and f32 compute keep the inline path; an inactive generator
    (rate 0) takes the core."""
    counting = _Counting()
    monkeypatch.setattr(fusion, "fusion_attention", counting)
    launches = fusion_attention.launches
    v, l_, mask_v, mask_l = _inputs("b2_ragged_nl")
    m16 = _module("b2_ragged_nl", torch.bfloat16)
    with torch.no_grad():
        m16(v, l_, mask_v, mask_l)
        assert counting.calls == 1
        m16(v, l_, mask_v, mask_l, generator=torch.Generator().manual_seed(0))
        assert counting.calls == 2  # rate 0: dropout is inactive
        _module("b2_ragged_nl", torch.bfloat16, dropout=0.1)(
            v, l_, mask_v, mask_l, generator=torch.Generator().manual_seed(0))
        _module("b2_ragged_nl", torch.float32)(v, l_, mask_v, mask_l)

        class _Dist:  # one seq rank: the reductions return their input
            @staticmethod
            def reduced(t, group, op):
                return t

            @staticmethod
            def all_reduce_sum(t, axis):
                return t

        monkeypatch.setattr(fusion, "dist", _Dist)
        m16(v, l_, mask_v, mask_l, shard=types.SimpleNamespace(group=None))
    m16(v, l_, mask_v, mask_l)
    assert counting.calls == 2
    assert fusion_attention.launches == launches


def test_bf16_inference_takes_the_core_on_the_cpu():
    """bf16 on the CPU: the module's inference output is the plain core's
    through its projections, bitwise."""
    m = _module("text_row_masked", torch.bfloat16)
    v, l_, mask_v, mask_l = _inputs("text_row_masked")
    with torch.no_grad():
        got = m(v, l_, mask_v, mask_l)
        want = _plain_through(m, v, l_, mask_v, mask_l)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


def _bf16(*shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).bfloat16()


@pytest.mark.parametrize("what", ["f32", "head_dim", "cpu", "shape", "grad", "mask"])
def test_cuda_wrapper_refuses_what_it_cannot_run(what):
    """The wrapper's checks raise before any launch (here on the CPU)."""
    q, k = _bf16(1, 10, 64), _bf16(1, 4, 64)
    args = [q, k, q.clone(), k.clone(), None, None, 2]
    match = {"f32": "bfloat16", "head_dim": "head dim", "cpu": "on cpu", "shape": "must be",
             "grad": "requires grad", "mask": "mask_l"}[what]
    if what == "f32":
        args[2] = args[2].float()
    elif what == "head_dim":
        args[6] = 4
    elif what == "shape":
        args[3] = _bf16(1, 5, 64)
    elif what == "grad":
        args[1] = args[1].float().requires_grad_(True).bfloat16()
    elif what == "mask":
        args[5] = torch.ones(1, 5, dtype=torch.bool)
    launches = fusion_attention.launches
    with pytest.raises(ValueError, match=match):
        fusion_attention_cuda(*args)
    assert fusion_attention.launches == launches


def test_neg_inf_is_the_models():
    assert fusion_attn.NEG_INF == NEG_INF


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    return torch.device("cuda")


# name: (B, Nv, Nl, heads, hd, mask_v, mask_l)
CARD_CASES = dict(CASES, **{
    "hd256_odinw": (1, 1500, 32, 4, 256, "part", "part"),
    "hd256_coco_like": (2, 3001, 256, 4, 256, "part", "row"),
    "hd256_ragged": (2, 777, 45, 4, 256, None, "part"),
})
CARD_REL_TOL = 2e-2  # bf16 outputs; P rounded to bf16 before (kernel) or after (plain) normalising


def _card_inputs(case, device):
    b, nv, nl, heads, hd, mv, ml = CARD_CASES[case]
    e = heads * hd
    g = torch.Generator().manual_seed(nv + nl)
    q = (torch.randn(b, nv, e, generator=g) * 2.0 * hd ** -0.5).bfloat16()
    k = torch.randn(b, nl, e, generator=g).bfloat16()
    vv = torch.randn(b, nv, e, generator=g).bfloat16()
    vl = torch.randn(b, nl, e, generator=g).bfloat16()
    mask_v = None if mv is None else torch.rand(b, nv, generator=g) > 0.3
    mask_l = None if ml is None else torch.rand(b, nl, generator=g) > 0.3
    if ml == "row":
        mask_l[1] = False
    put = [t.to(device) for t in (q, k, vv, vl)]
    put += [None if m is None else m.to(device) for m in (mask_v, mask_l)]
    return put + [heads]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernel_matches_plain_on_card(cuda_device, case):
    args = _card_inputs(case, cuda_device)
    before = fusion_attention.launches
    got = fusion_attention(*args)
    torch.cuda.synchronize()
    assert fusion_attention.launches == before + 1
    want = fusion_attention_plain(*args)
    for g_, w_, what in zip(got, want, ("out_v", "out_l")):
        scale = max(1.0, w_.float().abs().max().item())
        err = (g_.float() - w_.float()).abs().max().item()
        assert err <= CARD_REL_TOL * scale, (case, what, err, scale)


@pytest.mark.cuda
def test_module_takes_the_kernel_and_captures_on_card(cuda_device):
    """A bf16 module under inference_mode launches the kernel once a call,
    its output the plain core's within the card tolerance; the call captured
    in a CUDA graph replays to the eager output bitwise."""
    case = "b2_ragged_nl"
    m = _module(case, torch.bfloat16).to(cuda_device)
    v, l_, mask_v, mask_l = (t.to(cuda_device) for t in _inputs(case))
    with torch.inference_mode():
        before = fusion_attention.launches
        eager = m(v, l_, mask_v, mask_l)
        assert fusion_attention.launches == before + 1
        want = _plain_through(m, v, l_, mask_v, mask_l)
        for g_, w_ in zip(eager, want):
            assert (g_.float() - w_.float()).abs().max().item() <= CARD_REL_TOL * max(
                1.0, w_.float().abs().max().item())
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            m(v, l_, mask_v, mask_l)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = m(v, l_, mask_v, mask_l)
        graph.replay()
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
