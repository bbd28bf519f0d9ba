"""Tensor and sequence parallelism (`parallel/tp.py`, `parallel/sp.py`,
`parallel/mesh.py`) on the CPU, over gloo ranks (`tests/torch_ranks.py`,
whose rank jobs import no JAX), f32, at the tiny config:

  * the ZiRa forward and train step at batch 2 under `--mesh 1,2` (TP),
    `1,1,2` (SP) and `1,2,2` (both, four ranks) against JAX's single-device
    forward and step (the matcher pinned to JAX's assignments): detections
    at JAX_TOL with the same top-k queries, every loss and trainable
    gradient at JAX_TOL of its scale; and against the port's one process
    at PORT_TOL. The 64x96 images give 128 encoder tokens; a 213-token
    case (64x160, not a multiple of the seq size), the CAT preset (the
    adapters' self-KD mean over sharded tokens) and a step with every
    dropout on (the same generator in both runs) are held to the port's one
    process; so is a 193-token case (96x96), where the scalar `scaling`
    gradients' terms cancel, each such gradient held at PORT_TOL of the sum
    of its terms' magnitudes (`_scaling_terms`);
  * the sharded weights: `tp_targets` against the kernels that JAX's
    `param_sharding` shards on a `make_mesh(data=4, model=2)` of the 8 CPU
    devices; each rank holding half of each, and the sharded model's
    `state_dict()` giving the loaded weights back bitwise;
  * the model ranks' copies of the replicated trainable weights bitwise
    equal after AdamW steps whose gradients were moved apart on each rank;
  * `train_odinw --mesh 1,2` and `--mesh 1,1,2` against `--mesh 1`.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_image_batch, tiny_tokenizer
from tests.test_torch_pet import preset_overrides
from tests.test_train_step import make_batch
from tests.torch_common import TinyPair, init_shapes, port_config
from tests.torch_ranks import free_port, job_tp_sp, run_ranks, sharded_run
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.parallel import dist as pdist
from ziragroundingdino_torch.parallel import mesh as pmesh
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.weights import _INVERSE, jax_params_to_state_dict

JAX_TOL = 1e-4  # detections (abs), losses and gradients (of their scale) against JAX
PORT_TOL = 1e-5  # the same, of each tensor's scale, against the port's one process
MESHES = {"tp": (1, 2, 1), "sp": (1, 1, 2), "tp_sp": (1, 2, 2)}
# encoder tokens of `make_batch`'s 64x96 images (8x12 + 4x6 + 2x3 + 1x2), of
# 64x160 ones (8x20 + 4x10 + 2x5 + 1x3) and of 96x96 ones (12x12 + 6x6 + 3x3 +
# 2x2), the last two not a multiple of the seq size
TOKENS = {"zira": 128, "uneven": 213, "wide": 193}
DROPOUT = dict(dropout=0.1, text_dropout=0.1, fusion_dropout=0.1, fusion_droppath=0.1)
DROPOUT_SEED = 3


def _batch(w=96, h=64):
    """`make_batch`'s captions and targets on two h x w images."""
    batch = {k: np.asarray(v) for k, v in make_batch().items()}
    batch["pixels"], batch["mask"] = tiny_image_batch(b=2, h=h, w=w)
    return batch


def _recorded(fn):
    """fn() with the port's matcher recorded: (fn's result, the assignments)."""
    orig, seen = pcrit.match_batch, []

    def recording(*a, **k):
        out = orig(*a, **k)
        seen.append(out.numpy())
        return out

    pcrit.match_batch = recording
    try:
        return fn(), seen
    finally:
        pcrit.match_batch = orig


def _one_process(pcfg, sd, batch, assignments=None, seed=None):
    """The port's one-process `sharded_run` and the assignments it used."""
    model = build_model(pcfg, device="cpu", dtype="float32")
    model.load_state_dict(sd)
    if assignments is not None:
        return sharded_run(model, pcfg, batch, assignments, seed), assignments
    res, seen = _recorded(lambda: sharded_run(model, pcfg, batch, None, seed))
    return res, seen


def _scaling_terms(pcfg, sd, batch, assignments):
    """Each trainable scalar `scaling` gradient split into its terms: the
    port's one process with every such scalar widened to the shape of the
    branch it multiplies (`scaling * branch`), so that its gradient holds
    the term dL/d(scaled branch)_i * branch_i of each element i. Returns
    {name: (the terms' sum, the sum of their magnitudes)}, in f64."""
    model = build_model(pcfg, device="cpu", dtype="float32")
    model.load_state_dict(sd)
    poptim.set_trainable(model, poptim.trainable_patterns_for_cfg(pcfg),
                         freeze_all=pcfg.freeze_all)
    mods = {n: m for n, m in model.named_modules()
            if isinstance(getattr(m, "scaling", None), torch.nn.Parameter)
            and m.scaling.numel() == 1 and m.scaling.requires_grad}
    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    rows = torch.from_numpy(np.concatenate(assignments)).long()
    shapes = {}

    def recording(name, fn):
        def forward_train(*a, **k):
            out = fn(*a, **k)
            assert shapes.setdefault(name, out[0].shape) == out[0].shape, name
            return out
        return forward_train

    orig = pcrit.match_batch
    pcrit.match_batch = lambda *a, **k: rows
    try:
        for n, m in mods.items():
            m.forward_train = recording(n, m.forward_train)
        with torch.no_grad():
            pstep.compute_losses(model, t)
        for n, m in mods.items():
            m.scaling = torch.nn.Parameter(m.scaling.detach().expand(shapes[n]).clone())
        total, _ = pstep.compute_losses(model, t)
        total.backward()
    finally:
        pcrit.match_batch = orig
    return {f"{n}.scaling": (float(m.scaling.grad.double().sum()),
                             float(m.scaling.grad.double().abs().sum())) for n, m in mods.items()}


def _jax_forward_and_step(tp, batch):
    """JAX's eval detections and its step's losses, gradients (the port's
    names) and assignments."""
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train.step import compute_losses

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    text = {k: jb[k] for k in ("input_ids", "text_token_mask", "position_ids",
                               "text_self_attention_masks")}
    fwd = jax.jit(lambda p: tp.jmodel.apply({"params": p}, jb["pixels"], jb["mask"], text))(
        tp.params)
    recorded = []
    orig = jcrit.match_batch

    def recording(*a, **k):
        out = orig(*a, **k)
        recorded.append(out)
        return out

    def loss_fn(p):
        recorded.clear()
        total, losses = compute_losses(tp.jmodel, tp.variables(p), jb, train=True)
        return total, (losses, list(recorded))

    jcrit.match_batch = recording
    try:
        (_, (losses, assignments)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tp.params)
    finally:
        jcrit.match_batch = orig
    return ({k: np.asarray(fwd[k]) for k in ("pred_logits", "pred_boxes")},
            {k: float(v) for k, v in losses.items()},
            {n: v.numpy() for n, v in jax_params_to_state_dict(grads).items()},
            [np.asarray(a) for a in assignments])


def _odinw_inputs(root):
    """A tiny checkpoint, vocab, overrides (one image bucket, dropout off)
    and two synthetic ODinW tasks, as `tests/test_torch_ddp.py`'s driver
    test; returns the driver's arguments for an output dir."""
    from tests.test_torch_ddp import EVAL_DATA
    from tests.test_torch_trainer import TASKS, TINY_MODEL
    from ziragroundingdino_torch.config import load_config_overrides
    from ziragroundingdino_torch.data.synthetic import write_odinw_task, write_vocab

    ov = root / "overrides.json"
    ov.write_text(json.dumps({"model": TINY_MODEL,
                              "data": dict(EVAL_DATA, shape_buckets=((160, 224),))}))
    model = build_model("dualzerorepbranchgroundingdino", device="cpu", seed=0,
                        **load_config_overrides(str(ov))[0])
    torch.save({"model": model.state_dict()}, root / "ckpt.pth")
    write_vocab(str(root / "vocab.txt"), tiny_tokenizer().vocab)
    for i, (name, classes) in enumerate(TASKS.items()):
        write_odinw_task(str(root / "data"), name, classes, 4, 3, (96, 128), seed=10 * i)

    def args(out):
        return ["--checkpoint", str(root / "ckpt.pth"), "--vocab", str(root / "vocab.txt"),
                "--datasets-root", str(root / "data"), "--tasks", ",".join(TASKS),
                "--output-dir", str(root / out), "--batch-size", "2", "--max-iter", "1",
                "--checkpoint-period", "1", "--replay-iters", "1",
                "--config-overrides", str(ov), "--device", "cpu"]

    return args


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's forward and step, the port's one-process runs of every case,
    the three meshes' rank runs (TP's and SP's ending with `train_odinw`)
    and `train_odinw --mesh 1`."""
    tp = TinyPair(seed=1)
    pcfg, sd = port_config(tp.cfg), tp.port.state_dict()
    batch = _batch()
    jax_ref = {"zira": _jax_forward_and_step(tp, batch),
               "uneven": _jax_forward_and_step(tp, _batch(160))}
    cat = TinyPair(seed=2, **preset_overrides("catgroundingdino", num_experts=4,
                                              num_topk_experts=2))
    cat_cfg, cat_sd = port_config(cat.cfg), cat.port.state_dict()
    drop_cfg = dataclasses.replace(pcfg, **DROPOUT)
    wide = _batch(96, h=96)
    one = {"zira": _one_process(pcfg, sd, batch, jax_ref["zira"][3]),
           "uneven": _one_process(pcfg, sd, _batch(160), jax_ref["uneven"][3]),
           "wide": _one_process(pcfg, sd, wide),
           "dropout": _one_process(drop_cfg, sd, batch, seed=DROPOUT_SEED),
           "cat": _one_process(cat_cfg, cat_sd, batch)}
    cases = {
        "zira": ("zira", pcfg, sd, batch, one["zira"][1], None),
        "uneven": ("uneven", pcfg, sd, _batch(160), one["uneven"][1], None),
        "wide": ("wide", pcfg, sd, wide, one["wide"][1], None),
        "dropout": ("dropout", drop_cfg, sd, batch, one["dropout"][1], DROPOUT_SEED),
        "cat": ("cat", cat_cfg, cat_sd, batch, one["cat"][1], None),
    }
    terms = _scaling_terms(pcfg, sd, wide, one["wide"][1])
    root = tmp_path_factory.mktemp("odinw")
    args = _odinw_inputs(root)
    ranks = {
        "tp": run_ranks(job_tp_sp, MESHES["tp"],
                        [cases["zira"], cases["dropout"], cases["wide"]], args("mesh1_2")),
        "sp": run_ranks(job_tp_sp, MESHES["sp"], [cases[k] for k in cases], args("mesh1_1_2")),
        "tp_sp": run_ranks(job_tp_sp, MESHES["tp_sp"], [cases["zira"], cases["wide"]],
                           world=4),
    }
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("MASTER_ADDR", "127.0.0.1")
        mp.setenv("MASTER_PORT", str(free_port()))
        for k in ("RANK", "LOCAL_RANK"):
            mp.setenv(k, "0")
        mp.setenv("WORLD_SIZE", "1")
        from ziragroundingdino_torch.scripts import train_odinw

        report1 = train_odinw.main(args("mesh1") + ["--mesh", "1"])
    finally:
        mp.undo()
    assert not pdist.is_initialized()
    return dict(jax=jax_ref, one={k: v[0] for k, v in one.items()}, ranks=ranks, root=root,
                report1=report1, terms=terms)


def _scale(t):
    """The largest magnitude of the entries that a mask did not set (|x| <
    1e6: a masked logit is -1e9 in both runs)."""
    a = np.abs(np.asarray(t, np.float64))
    return max(a[a < 1e6].max(initial=0.0), 1e-30)


def _err(got, want, of_scale=True):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max(initial=0.0) / (_scale(want) if of_scale else 1.0)


def _check_step(losses, grads, want_losses, want_grads, tol, what, terms=None):
    """Every loss at `tol` relative, every trainable gradient at `tol` of
    its scale; a gradient the loss did not reach (CAT's `w_noise` without
    noisy gating) is None where the reference's is missing or 0. Where
    `terms` ({name: (sum, sum of magnitudes)}, `_scaling_terms`) has a
    scalar gradient, it is held at `tol` of the sum of its terms'
    magnitudes: each term agrees at `tol` as the tensors it is made of do,
    and a sum in another order (other chunks, other partial sums) then
    agrees at `tol` times that sum (its f32 rounding, sqrt(N) * 6e-8 of it,
    lies below), while its own scale may be far smaller where the terms
    cancel."""
    for k, v in want_losses.items():
        assert abs(losses[k] - v) <= tol * max(abs(v), 1e-30), (what, k, losses[k], v)
    for n, g in grads.items():
        want = want_grads[n]
        want = want.numpy() if isinstance(want, torch.Tensor) else want
        if g is None:
            assert want is None or not np.any(want), (what, n)
            continue
        if terms is not None and n in terms:
            err = _err(g, want, of_scale=False)
            assert err <= tol * terms[n][1], (what, n, err, terms[n])
            continue
        assert _err(g, want) <= tol, (what, n, _err(g, want))


def _rank_results(runs, mesh, case):
    return [cases[case] for cases, _ in runs["ranks"][mesh]]


@pytest.mark.parametrize("mesh,case", [("tp", "zira"), ("sp", "zira"), ("tp_sp", "zira"),
                                       ("sp", "uneven")])
def test_forward_and_step_match_jax(runs, mesh, case):
    """Every rank's detections (JAX_TOL abs; the top-k queries those of the
    port's one process, which `tests/test_torch_model.py` holds to JAX's),
    losses and trainable gradients (JAX_TOL of their scale) against JAX's
    single device, at 128 and at 213 encoder tokens."""
    jfwd, jlosses, jgrads, _ = runs["jax"][case]
    valid = np.abs(jfwd["pred_logits"]) < 1e6
    assert np.abs(jfwd["pred_boxes"] - 0.5).max() > 1e-3  # boxes off their anchors
    for rank, res in enumerate(_rank_results(runs, mesh, case)):
        logits, boxes, topk, losses, grads = res[:5]
        assert np.abs(logits.numpy() - jfwd["pred_logits"])[valid].max() <= JAX_TOL, rank
        assert _err(boxes, jfwd["pred_boxes"], of_scale=False) <= JAX_TOL, rank
        assert torch.equal(topk, runs["one"][case][2]), rank
        _check_step(losses, grads, jlosses, jgrads, JAX_TOL, f"{mesh} rank {rank}")


@pytest.mark.parametrize("mesh,case", [("tp", "zira"), ("sp", "zira"), ("tp_sp", "zira"),
                                       ("sp", "uneven"), ("tp", "wide"), ("sp", "wide"),
                                       ("tp_sp", "wide")])
def test_sharded_run_matches_one_process(runs, mesh, case):
    """Every rank against the port's one process at PORT_TOL: detections,
    losses, gradients (at 96x96 the scalar `scaling` ones of the sum of
    their terms' magnitudes, `_check_step`), all ranks alike; each
    tensor-parallel rank holds half of each sharded weight (JAX's
    `_TP_RULES` set, `test_tp_targets_match_jax`), and the sharded model's
    `state_dict()` gives the loaded weights back bitwise."""
    want = runs["one"][case]
    results = _rank_results(runs, mesh, case)
    terms = runs["terms"] if case == "wide" else None
    for rank, (logits, boxes, topk, losses, grads, counts, same, _) in enumerate(results):
        assert _err(logits, want[0]) <= PORT_TOL and _err(boxes, want[1]) <= PORT_TOL, rank
        _check_step(losses, grads, want[3], want[4], PORT_TOL, f"{mesh} rank {rank}", terms)
        assert losses == results[0][3]
        assert same, rank
        if MESHES[mesh][1] == 1:
            assert counts == {}
        else:
            assert counts and all(local * 2 == whole for local, whole in counts.values())


@pytest.mark.parametrize("mesh,case", [("sp", "zira"), ("sp", "uneven"), ("tp_sp", "zira"),
                                       ("tp_sp", "wide")])
def test_sp_token_chunks(runs, mesh, case):
    """Under a seq axis of 2 each rank's encoder MSDA runs its chunk of the
    queries (64 of 128, 107 of 213, 97 of 193) against the whole value table, and the
    decoder's 6 of its 12 queries against the whole memory; without one,
    every call runs them all."""
    n = TOKENS[case]
    for cases, _ in runs["ranks"][mesh]:
        calls = cases[case][7]
        # the eval forward's 2 encoder and 2 decoder layers
        assert calls[:4] == [(n, -(-n // 2))] * 2 + [(n, 6)] * 2, calls
    for cases, _ in runs["ranks"]["tp"]:
        assert cases["zira"][7][:4] == [(128, 128)] * 2 + [(128, 12)] * 2


def test_scaling_terms_add_up_and_cancel(runs):
    """`_scaling_terms` splits each scalar `scaling` gradient of the 96x96
    case into terms that add up to the one process's gradient (at PORT_TOL
    of their magnitudes), and some of them cancel: their magnitudes' sum
    exceeds the gradient's own scale, which is why `_check_step` holds
    these gradients to it."""
    terms, grads = runs["terms"], runs["one"]["wide"][4]
    assert len(terms) == 5  # four input-projection levels and the language branch
    for n, (total, magnitude) in terms.items():
        g = float(grads[n].double().sum())
        assert abs(total - g) <= PORT_TOL * magnitude, (n, total, g, magnitude)
    assert max(m / max(abs(t), 1e-30) for t, m in terms.values()) > 2.0


@pytest.mark.parametrize("mesh", ["tp", "tp_sp"])
def test_model_ranks_keep_one_copy_of_replicated_weights(runs, mesh):
    """Two AdamW steps with each model rank's gradients moved apart before
    the optimizer (as the card's unordered atomics move them): the model
    ranks' replicated gradients differed, and the optimizer's mean over the
    model axis leaves their replicated trainable weights bitwise equal."""
    for cases, _ in runs["ranks"][mesh]:
        differed, same = cases["replicas"]
        assert differed and same


def test_cat_under_sp(runs):
    """CAT (in-layer adapters with the self-KD L1 of the encoder's sharded
    tokens: the mean over a global count) under `--mesh 1,1,2` against the
    port's one process at PORT_TOL."""
    want = runs["one"]["cat"]
    assert want[3]["loss_adapter"] > 0.0
    for rank, res in enumerate(_rank_results(runs, "sp", "cat")):
        logits, boxes, topk, losses, grads = res[:5]
        assert _err(logits, want[0]) <= PORT_TOL and _err(boxes, want[1]) <= PORT_TOL
        _check_step(losses, grads, want[3], want[4], PORT_TOL, f"cat rank {rank}")


@pytest.mark.parametrize("mesh", ["sp", "tp"])
def test_dropout_step_matches_one_process(runs, mesh):
    """A step with every dropout and drop path on, drawn from one generator
    on every rank (the fusion layers' attention masks drawn at the unsharded
    shape under SP), against the one process's step with the same generator
    at PORT_TOL; the masks move the losses."""
    want = runs["one"]["dropout"]
    assert abs(want[3]["total_loss"] - runs["one"]["zira"][3]["total_loss"]) > 1e-3
    for rank, res in enumerate(_rank_results(runs, mesh, "dropout")):
        _check_step(res[3], res[4], want[3], want[4], PORT_TOL, f"{mesh} rank {rank}")


@pytest.mark.parametrize("mesh", ["tp", "sp"])
def test_train_odinw_mesh_matches_mesh1(runs, mesh):
    """`train_odinw --mesh 1,2` / `--mesh 1,1,2` on two synthetic tasks (one
    step each, the replay, the eval) against `--mesh 1`: the same report,
    every chained tensor at PORT_TOL (as `tests/test_torch_ddp.py`'s
    STATE_TOL, absolute: one AdamW step moves a weight by lr whatever its
    gradient's size); the checkpoints hold whole weights that load into one
    process strictly."""
    from tests.test_torch_trainer import TASKS
    from ziragroundingdino_torch.config import load_config_overrides

    out = runs["root"] / ("mesh1_2" if mesh == "tp" else "mesh1_1_2")
    for _, report in runs["ranks"][mesh]:
        assert report == runs["report1"]
    model = build_model("dualzerorepbranchgroundingdino", device="cpu", seed=0,
                        **load_config_overrides(str(runs["root"] / "overrides.json"))[0])
    for name in TASKS:
        got = torch.load(out / name / "state_final.pt", weights_only=True)["params"]
        want = torch.load(runs["root"] / "mesh1" / name / "state_final.pt",
                          weights_only=True)["params"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, atol=PORT_TOL, rtol=0,
                                       msg=lambda m, k=k: f"{name} {k}: {m}")
        ckpt = torch.load(out / name / "ckpt" / "step_1.pt", weights_only=True)
        model.load_state_dict(ckpt["model"], strict=True)
        assert all(torch.equal(t, ckpt["model"][k]) for k, t in model.state_dict().items())


def _jax_sharded_keys(tp):
    """The port's names of the kernels that JAX's `param_sharding` puts on
    the model axis of a `make_mesh(data=4, model=2)`, through the weight
    bridge's rules."""
    from ziragroundingdino_tpu.parallel.mesh import make_mesh, param_sharding

    mesh = make_mesh(data=4, model=2, devices=jax.devices()[:8])
    shapes = init_shapes(tp.jmodel, tp.pixels, tp.mask, tp.text)["params"]
    keys = set()
    for path, s in jax.tree_util.tree_leaves_with_path(param_sharding(shapes, mesh)):
        if "model" not in str(s.spec):
            continue
        p = "/".join(str(getattr(k, "key", k)) for k in path)
        key = next(m.expand(t) for pat, t, _ in _INVERSE if (m := pat.match(p)))
        keys.add(key)
    return keys


@pytest.mark.parametrize("preset,extra", [
    ("dualzerorepbranchgroundingdino", {}),
    ("dtgroundingdino", {}),
    ("dtgroundingdino", {"cet_type": "Transformer"}),
])
def test_tp_targets_match_jax(preset, extra):
    """`tp_targets` on a model axis of 2 is the set of kernels JAX shards
    (`output_dense/kernel$` matching BERT's `attention_output_dense` too),
    each along JAX's dimension: output features for P(None, "model"),
    input features for P("model", None)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    tp = TinyPair(**preset_overrides(preset, **extra))
    targets = pmesh.tp_targets(tp.port, pmesh.Mesh(model=2))
    assert set(targets) == _jax_sharded_keys(tp)
    assert any(".attention.output.dense." in k for k in targets)
    for name, dim in targets.items():
        want = 1 if name.endswith((".linear2.weight", ".output.dense.weight",
                                   ".mlp.fc2.weight")) else 0
        assert dim == want, name
    if extra:
        assert {"cet_adapter.linear1.weight", "cet_adapter.linear2.weight",
                "cet_adapter.self_attn.in_proj_weight"} <= set(targets)
