"""The PET baselines and CAT against the JAX package, f32 on the CPU.

* Modules, with the same seeded parameters carried over by the weight
  bridge, at 1e-5: the cosine-similarity `_Gate`, `Adapter` and
  `LinearAdapter` (with and without the self-KD loss),
  `TransformerAdapter`, `ContrastiveEmbed(use_linear=True)`, and
  `MoeAdapter` / `MoE` with one expert and with four (top 2): eval with
  seeded gates, eval at the ties of the zero-init gate (both pick the
  lowest indices), and noisy train gating with JAX's normal draws replaced
  by a seeded array that the port gets as `noise`. Each MoE case holds the
  output, the balancing loss, every gradient, and the gate matrix itself
  (read out through experts whose output is their one-hot index).
* Whole forwards of the seven presets at `tiny_config`: the JAX model in
  train mode (which for these presets computes what eval mode does, and
  the adapter losses besides) against the port's eval forward
  (`pred_logits`, `pred_boxes`, `encoded_text` at 1e-4, the top-k query
  indices equal) and its train forward (the same, and `adapter_losses` at
  1e-5). The bridge's strict load of each preset's parameters checks that
  its names (the CET, in-layer and MoE adapters, `cls_linear`, the
  separate two-stage head) cover the model.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_common import TinyPair, assert_close, random_params, torch_text
from ziragroundingdino_torch.models import adapters as padapters
from ziragroundingdino_torch.models.heads import ContrastiveEmbed
from ziragroundingdino_torch.models.moe import MoE
from ziragroundingdino_torch.weights import jax_params_to_state_dict
from ziragroundingdino_tpu.models import adapters as jadapters
from ziragroundingdino_tpu.models import heads as jheads

MODULE_TOL = 1e-5  # one module: a few matmuls and a norm, f32
ATOL = 1e-4  # whole forward, as tests/test_torch_model.py
LOSS_TOL = 1e-5  # the adapter losses: means over one module's input or output

D, TOKENS = 16, 7


def _t(x):
    return torch.from_numpy(np.array(x))


def _x(seed=0, b=2, n=TOKENS, d=D):
    return np.random.RandomState(seed).randn(b, n, d).astype(np.float32)


def load_module(module, jparams, path, strip=None):
    """Load a JAX module's parameters into the port's `module` through the
    bridge, as if the module sat at `path` (a JAX path, "/"-joined) of the
    model; `strip` is the torch prefix to take off (default: the path)."""
    tree = jparams
    for part in reversed(path.split("/")):
        tree = {part: tree}
    sd = jax_params_to_state_dict(tree)
    prefix = strip or re.sub(r"_(\d+)", r".\1", path.replace("/", ".")) + "."
    assert sd and all(k.startswith(prefix) for k in sd), sorted(sd)
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module


def _init_params(jmod, *args, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kw))
    return random_params(shapes["params"], seed=1)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

# case: (JAX module, port module, the model path the bridge maps)
def _adapter_case(kind):
    if kind == "gate":
        return (jadapters._Gate(embed_dim=D, output_dim=D, gate_base_scale=0.3),
                padapters._Gate(D, gate_base_scale=0.3), "cet_adapter/gate")
    if kind == "adapter":
        return (jadapters.Adapter(embed_dim=D, down_dim=8, output_dim=12, gate_base_scale=0.7),
                padapters.Adapter(D, 8, 0.7, use_self_kd=True, output_dim=12), "cet_adapter")
    if kind == "adapter_no_kd":
        return (jadapters.Adapter(embed_dim=D, down_dim=8, use_self_kd=False),
                padapters.Adapter(D, 8, use_self_kd=False), "transformer/encoder/layers_1/adapter")
    if kind == "linear":
        return (jadapters.LinearAdapter(embed_dim=D, output_dim=12, gate_base_scale=1.0),
                padapters.LinearAdapter(D, 1.0, use_self_kd=True, output_dim=12), "cet_adapter")
    return (jadapters.TransformerAdapter(embed_dim=D, nhead=4, down_dim=24, use_self_kd=True,
                                         output_dim=12),
            padapters.TransformerAdapter(D, 4, 24, use_self_kd=True, output_dim=12),
            "cet_adapter")


@pytest.mark.parametrize("kind", ["gate", "adapter", "adapter_no_kd", "linear", "transformer"])
def test_adapter_matches_jax(kind):
    """Output and loss at 1e-5, the zero-init up projections made non-zero
    by the seeded parameters; the gate's output is [..., 1] in [0, scale]."""
    jmod, pmod, path = _adapter_case(kind)
    x = _x()
    params = _init_params(jmod, jnp.asarray(x))
    load_module(pmod, params, path)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    got = pmod(_t(x))
    if kind == "gate":
        assert got.shape == (2, TOKENS, 1) and 0 < got.min() and got.max() < 0.3
        assert_close(got, want, MODULE_TOL, what="gate")
        return
    assert_close(got[0], want[0], MODULE_TOL, what=f"{kind}: output")
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=MODULE_TOL, atol=1e-12,
                               err_msg=f"{kind}: loss")
    assert (got[1].item() > 0) == (kind != "adapter_no_kd")
    assert got[0].abs().max() > 1e-3  # the seeded up projection acts


def test_contrastive_embed_with_linear_matches_jax():
    """`ContrastiveEmbed(use_linear=True)`: the queries through `cls_linear`,
    then the text dot product, padded tokens and columns at NEG_INF."""
    max_len, t = 12, 9
    x = _x(3, n=5)
    y = _x(4, n=t)
    mask = np.arange(t)[None] < np.array([[t], [4]])
    text = {"encoded_text": y, "text_token_mask": mask}
    jmod = jheads.ContrastiveEmbed(max_text_len=max_len, use_linear=True, hidden_dim=D)
    params = _init_params(jmod, jnp.asarray(x), {k: jnp.asarray(v) for k, v in text.items()})
    pmod = load_module(ContrastiveEmbed(max_len, True, D), params, "class_embed",
                       strip="class_embed.0.")
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in text.items()})
    got = pmod(_t(x), {k: _t(v) for k, v in text.items()})
    assert got.shape == (2, 5, max_len)
    assert_close(got, want, MODULE_TOL * 10, what="logits")  # 1e-9 pads: relative 1e-5
    assert (got[1, :, 4:] == -1e9).all()


# (experts, top k, mode): mode "eval" (seeded gates), "ties" (the zero
# init's gates, every logit 0), "noisy" (train, injected noise)
MOE_CASES = [(1, 1, "eval"), (4, 2, "eval"), (4, 2, "ties"), (1, 1, "noisy"), (4, 2, "noisy")]


class MoePair:
    """`MoeAdapter` of both packages (hidden 8, output 12, scale 0.5, self-KD
    on), the same seeded parameters, a [2, 7, 16] input, and in the noisy
    mode the [14, E] normal draws both use."""

    def __init__(self, e, k, mode):
        self.e, self.k, self.mode = e, k, mode
        self.jmod = jadapters.MoeAdapter(embed_dim=D, down_dim=8, output_dim=12,
                                         gate_base_scale=0.5, num_experts=e, topk=k)
        self.x = _x(5)
        self.params = _init_params(self.jmod, jnp.asarray(self.x))
        if mode == "ties":
            moe = self.params["adapter_moe"]
            moe["w_gate"] = np.zeros_like(moe["w_gate"])
            moe["w_noise"] = np.zeros_like(moe["w_noise"])
        self.noise = (np.random.RandomState(6).randn(2 * TOKENS, e).astype(np.float32)
                      if mode == "noisy" else None)

    def port(self, params=None):
        mod = padapters.MoeAdapter(D, 8, 0.5, self.e, self.k, use_self_kd=True, output_dim=12)
        return load_module(mod, self.params if params is None else params,
                           "prompt_adapter", strip="prompt_adapter.")

    def jax_apply(self, params, monkeypatch):
        """(output, loss) of the JAX module; its noise is `self.noise`."""
        noisy = self.mode == "noisy"
        if noisy:
            monkeypatch.setattr(jax.random, "normal",
                                lambda key, shape, dtype=jnp.float32: jnp.asarray(
                                    self.noise, dtype).reshape(shape))
        out = self.jmod.apply({"params": params}, jnp.asarray(self.x), not noisy,
                              rngs={"gating": jax.random.PRNGKey(0)} if noisy else None)
        monkeypatch.undo()
        return out

    def port_apply(self, mod):
        noise = None if self.noise is None else _t(self.noise)
        return mod(_t(self.x), noise=noise)

    def readout_params(self):
        """The gate parameters with experts whose output is their one-hot
        index: the output is then 0.5 * the gate matrix."""
        p = {k: dict(v) if isinstance(v, dict) else v for k, v in self.params.items()}
        moe = p["adapter_moe"]
        moe["fc2_kernel"] = np.zeros_like(moe["fc2_kernel"])
        moe["fc2_bias"] = np.eye(self.e, 12, dtype=np.float32)
        return p


@pytest.mark.parametrize("e, k, mode", MOE_CASES)
def test_moe_adapter_matches_jax(e, k, mode, monkeypatch):
    """Output, balancing loss (cv^2 of importance and load; 0 with one
    expert), the gate matrix and every gradient at 1e-5 of its scale."""
    mp = MoePair(e, k, mode)
    mod = mp.port()
    want_y, want_loss = mp.jax_apply(mp.params, monkeypatch)
    y, loss = mp.port_apply(mod)
    assert_close(y, want_y, MODULE_TOL, what="output")
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=MODULE_TOL, atol=1e-7,
                               err_msg="loss")
    if e == 1:  # no balancing loss: the self-KD L1 of the output before its 0.5 scale
        assert loss.item() == pytest.approx(2 * float(np.abs(y.detach().numpy()).mean()))

    # the gate matrix
    gates_want, _ = mp.jax_apply(mp.readout_params(), monkeypatch)
    gates, _ = mp.port_apply(mp.port(mp.readout_params()))
    gates = gates.detach().reshape(-1, 12)[:, :e] * 2.0
    assert_close(gates, np.asarray(gates_want).reshape(-1, 12)[:, :e] * 2.0, MODULE_TOL,
                 what="gates")
    assert ((gates > 0).sum(-1) == k).all()
    torch.testing.assert_close(gates.sum(-1), torch.ones(2 * TOKENS))
    if mode == "ties":  # every logit 0: the lowest k indices, equal weights
        assert (gates[:, :k] == 1.0 / k).all() and (gates[:, k:] == 0).all()

    # gradients of sum(y * w) + loss
    w = np.random.RandomState(7).randn(*np.shape(want_y)).astype(np.float32)

    def jloss(p):
        yy, ll = mp.jax_apply(p, monkeypatch)
        return jnp.sum(yy * w) + ll

    jgrads = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, mp.params))
    want = {k[len("prompt_adapter."):]: v for k, v in
            jax_params_to_state_dict({"prompt_adapter": jax.tree_util.tree_map(
                np.asarray, jgrads)}).items()}
    yy, ll = mp.port_apply(mod)
    ((yy * _t(w)).sum() + ll).backward()
    moved = set()
    for n, p in mod.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # w_noise is unused in eval
        scale = max(float(np.abs(want[n].numpy()).max()), 1e-30)
        err = float((g - want[n]).abs().max()) / scale
        assert err <= MODULE_TOL, (n, err)
        if scale > 1e-6:
            moved.add(n)
    assert {"adapter_moe.experts.0.fc1.weight", "adapter_moe.experts.0.fc2.bias"} <= moved
    # the gate learns where it chooses between experts, the noise where it is drawn
    assert ("adapter_moe.w_gate" in moved) == (e > 1)
    assert ("adapter_moe.w_noise" in moved) == (e > 1 and mode == "noisy")


def test_moe_is_stable_under_a_generator():
    """With a generator the gate is noisy (its draws), and the same seed
    gives the same output; without one the gate is the clean top k."""
    mp = MoePair(4, 2, "eval")
    mod = mp.port()
    x = _t(mp.x)
    clean, _ = mod(x)
    a, _ = mod(x, torch.Generator().manual_seed(3))
    b, _ = mod(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - clean).abs().max() > 1e-4
    torch.testing.assert_close(mod(x)[0], clean, rtol=0, atol=0)


def test_moe_init_follows_jax():
    """fc1 uniform in +-1/sqrt(d) with zero bias; fc2, w_gate, w_noise
    zero; the reference's mean/std buffers 0 and 1."""
    from ziragroundingdino_torch.models.layers import init_weights

    mod = MoE(64, 32, 3, 16, k=2)
    init_weights(mod, torch.Generator().manual_seed(0))
    for ex in mod.experts:
        w = ex.fc1.weight
        assert w.abs().max() <= 1 / 8 and w.abs().max() > 0.1 and w.std() > 0.05
        assert (ex.fc1.bias == 0).all() and (ex.fc2.weight == 0).all()
        assert (ex.fc2.bias == 0).all()
    assert (mod.w_gate == 0).all() and (mod.w_noise == 0).all()
    assert mod.mean.tolist() == [0.0] and mod.std.tolist() == [1.0]
    assert sorted(mod.state_dict()) == sorted(
        ["w_gate", "w_noise", "mean", "std"]
        + [f"experts.{e}.fc{i}.{p}" for e in range(3) for i in (1, 2) for p in ("weight", "bias")])


# ---------------------------------------------------------------------------
# whole forwards
# ---------------------------------------------------------------------------

PRESETS = ("dtgroundingdino", "finetune", "linearprobe", "prompttune", "berttune",
           "projecttune", "catgroundingdino")


def preset_overrides(preset, **extra):
    """The fields where the JAX preset differs from the default config."""
    from ziragroundingdino_tpu.config import MODEL_PRESETS, GroundingDINOConfig

    cfg, default = MODEL_PRESETS[preset], GroundingDINOConfig()
    ov = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if getattr(cfg, f.name) != getattr(default, f.name)}
    return dict(ov, **extra)


def enc_logits(tp, inter):
    """The two-stage head's scores of the encoder memory: the separate
    head's call under `use_cls_linear`, else the shared head's first."""
    head = "enc_out_class_embed" if tp.cfg.use_cls_linear else "class_embed"
    return inter[head]["__call__"][0]


def run_pair(tp):
    """JAX's train-mode output with its intermediates, the port's eval and
    train outputs."""
    fwd = jax.jit(lambda v, px, m, t: tp.jmodel.apply(v, px, m, t, train=True,
                                                      capture_intermediates=True))
    jout, inter = fwd(tp.variables(), jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text)
    args = (torch.from_numpy(tp.pixels), torch.from_numpy(tp.mask), torch_text(tp.tb))
    with torch.inference_mode():
        pout = tp.port(*args)
        ptrain = tp.port(*args, train=True)
    return jout, inter["intermediates"], pout, ptrain


def check_forward(case, tp, jout, inter, outs, adapters=True):
    _, jidx = jax.lax.top_k(jnp.max(enc_logits(tp, inter), axis=-1), tp.cfg.num_queries)
    for mode, out in outs.items():
        what = f"{case} ({mode})"
        np.testing.assert_array_equal(out["topk_idx"].numpy(), np.asarray(jidx), err_msg=what)
        for k in ("pred_logits", "pred_boxes", "encoded_text"):
            assert_close(out[k], jout[k], ATOL, what=f"{what}: {k}")
    if not adapters:
        return
    want = {k: float(v) for k, v in jout["adapter_losses"].items()}
    got = {k: v.item() for k, v in outs["train"]["adapter_losses"].items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, atol=1e-9, err_msg=k)
    return got


@pytest.fixture(scope="module", params=PRESETS)
def served(request):
    tp = TinyPair(seed=0, **preset_overrides(request.param))
    return request.param, tp, *run_pair(tp)


def test_preset_forward_matches_jax(served):
    """Top-k equal, detections and encoded text at 1e-4 in eval and train
    mode; the adapter losses at 1e-5 (CAT's in-layer and prompt losses
    non-zero, every other preset's zero)."""
    case, tp, jout, inter, pout, ptrain = served
    losses = check_forward(case, tp, jout, inter, {"eval": pout, "train": ptrain})
    assert (losses["loss_adapter"] > 0) == (case == "catgroundingdino")
    assert losses["loss_linear_adapter"] == 0.0 and losses["loss_conv_adapter"] == 0.0


def test_preset_modules(served):
    """What each preset builds beside the vanilla model: the CET adapter
    (dt), the in-layer adapters and the MoE prompt (CAT), `cls_linear` and
    the separate two-stage head (linearprobe), nothing for the others;
    the shared heads aliased onto the decoder."""
    case, tp = served[:2]
    model = tp.port
    names = {n for n, _ in model.named_parameters()}
    groups = {"cet_adapter.": "cet", "prompt_adapter.": "prompt",
              "encoder.layers.0.adapter.": "encoder adapters",
              "decoder.layers.0.adapter.": "decoder adapters",
              "class_embed.0.cls_linear.": "cls_linear",
              "enc_out_class_embed.cls_linear.": "two-stage cls_linear"}
    got = {g for pat, g in groups.items() if any(pat in n for n in names)}
    want = {"dtgroundingdino": {"cet"}, "linearprobe": {"cls_linear", "two-stage cls_linear"},
            "catgroundingdino": {"prompt", "encoder adapters", "decoder adapters"}}
    assert got == want.get(case, set())
    assert model.transformer.decoder.class_embed is model.class_embed
    sd = model.state_dict()
    last = tp.cfg.dec_layers - 1
    if case == "linearprobe":
        w = sd["class_embed.0.cls_linear.weight"]
        for key in (f"class_embed.{last}.cls_linear.weight",
                    f"transformer.decoder.class_embed.{last}.cls_linear.weight"):
            assert sd[key].data_ptr() == w.data_ptr()
        assert not torch.equal(sd["transformer.enc_out_class_embed.cls_linear.weight"], w)
    if case == "catgroundingdino":
        assert sd["prompt_adapter.adapter_moe.std"].tolist() == [1.0]
        assert len([n for n in names if n.endswith("adapter.gate.weight")]) == (
            tp.cfg.enc_layers + tp.cfg.dec_layers)


# case: (preset, overrides): the CET adapter's other shapes, CET on a rep
# variant, and CAT's prompt with four experts
VARIANTS = {
    "dt_linear": ("dtgroundingdino", {"cet_type": "Linear"}),
    "dt_transformer": ("dtgroundingdino", {"cet_type": "Transformer"}),
    "rep_cet": ("repgroundingdino", {"use_cet": True}),
    "cat_e4k2": ("catgroundingdino", {"num_experts": 4, "num_topk_experts": 2}),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_variant_forward_matches_jax(case):
    """As `test_preset_forward_matches_jax`. `repgroundingdino` with
    `use_cet` builds the CET adapter beside its vision branches, which run
    in train mode only: its eval forward is held against JAX's eval."""
    preset, extra = VARIANTS[case]
    tp = TinyPair(seed=0, **preset_overrides(preset, **extra))
    jout, inter, pout, ptrain = run_pair(tp)
    if case == "rep_cet":
        jeval, ieval = jax.jit(lambda v, px, m, t: tp.jmodel.apply(
            v, px, m, t, capture_intermediates=True))(
            tp.variables(), jnp.asarray(tp.pixels), jnp.asarray(tp.mask), tp.text)
        check_forward(case, tp, jeval, ieval["intermediates"], {"eval": pout}, adapters=False)
        losses = check_forward(case, tp, jout, inter, {"train": ptrain})
        assert losses["loss_conv_adapter"] > 0
    else:
        losses = check_forward(case, tp, jout, inter, {"eval": pout, "train": ptrain})
    assert tp.port.lang_adapter_name == ("cet_adapter" if "cet" in case or "dt" in case else None)
    kind = {"dt_linear": padapters.LinearAdapter, "dt_transformer": padapters.TransformerAdapter,
            "rep_cet": padapters.Adapter}.get(case)
    if kind is not None:
        assert type(tp.port.lang_adapter) is kind
    if case == "cat_e4k2":
        moe = tp.port.prompt_adapter.adapter_moe
        assert len(moe.experts) == 4 and moe.k == 2 and losses["loss_adapter"] > 0
