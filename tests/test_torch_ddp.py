"""The port's data parallelism on the CPU: two gloo ranks, started by
`torch.multiprocessing.spawn` on a free local port (one spawn per test, every
case of the test inside it; their jobs are in `tests/torch_ranks.py`), against the JAX package's one-device step and
eval at the global batch, f32, tiny config, from numpy seeds.

* (a) A 2-rank DDP step (`train.step.wrap_ddp` + `train_step`) at global
  batch 2, one image a rank, for `dualzerorepbranchgroundingdino` (the
  masked language ZIL over captions with different numbers of valid
  tokens, the set criterion's global `num_boxes`), `repconvbngroundingdino`
  (BatchNorm on the global batch's statistics) and `catgroundingdino` with
  4 experts, top 2 (the MoE balance loss of the global sums, the unused
  `w_noise`): the global
  losses at 1e-5 and every trainable gradient at 1e-4 of its scale against
  JAX's `jax.grad` at batch 2, both matchers pinned to JAX's assignments;
  the two ranks' gradients equal.
* (b) `Optimizer(batch_size_scale=2)` against `optax.MultiSteps`: the
  parameters, the EMA and the schedule's count after 2 and 4 calls.
* (c) The sharded eval of 3 images of three sizes at global batch 2 (the
  last batch padded, each slice at its global batch's bucket): the
  detections of every image against JAX's and the one-process port's, and
  every COCO metric against both (`inference_on_dataset`), then
  `eval_coco --mesh 2` against `eval_coco`.
* (d) `train_odinw --mesh 2` on two synthetic tasks (1 step a task, dropout
  off): the chained state dicts and the report against `--mesh 1`'s at the
  same global batch.

And, in one process: `shard_indices_for_process` index for index JAX's,
`make_mesh`'s and the scripts' refusals, the rank's dropout generator, the
trainer's eval hook, and the io / events helpers against JAX's.
"""

import dataclasses
import io
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from tests.common import tiny_tokenizer
from tests.test_torch_pet import preset_overrides
from tests.torch_common import TinyPair, port_config
from tests.torch_ranks import (
    EVAL_DATA,
    SELECT_K,
    free_port,
    job_eval,
    job_step,
    job_train_odinw,
    port_eval,
    run_ranks,
)
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.parallel import dist as pdist
from ziragroundingdino_torch.parallel import mesh as pmesh
from ziragroundingdino_torch.train import optim as poptim
from ziragroundingdino_torch.weights import jax_params_to_state_dict

LOSS_TOL = 1e-5  # the global losses, relative: f32 rounding through the tiny model
STEP_TOL = 1e-4  # each trainable gradient, times its own largest magnitude
# a gradient that is 0 in exact arithmetic (a conv bias that a batch-statistics
# BatchNorm follows), times its conv weight gradient's scale
ZERO_GRAD_TOL = 1e-6
OPT_TOL = 1e-6  # the accumulated update against optax: one AdamW step in f32
DET_TOL = 1e-4  # detections, scores and pixel boxes: f32 through the tiny model
STATE_TOL = 1e-5  # the chained weights, --mesh 2 against --mesh 1
# (preset, overrides): CAT with 4 experts, top 2, so that its MoE balance loss
# is not the 0 of one expert
PRESETS = (("dualzerorepbranchgroundingdino", {}), ("repconvbngroundingdino", {}),
           ("catgroundingdino", {"num_experts": 4, "num_topk_experts": 2}))


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# (a) the DDP step against JAX's global-batch step
# ---------------------------------------------------------------------------


def _jax_step(preset, overrides):
    """JAX's losses, gradients (the port's names) and matcher assignments of
    `compute_losses` at batch 2 (`tests/test_torch_pet_train.py::jax_step`),
    and what a rank needs to rebuild the port's model."""
    from tests.test_train_step import make_batch
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train.step import compute_losses

    tp = TinyPair(seed=1, **preset_overrides(preset, **overrides))
    batch = make_batch()
    recorded = []
    orig = jcrit.match_batch

    def recording(*a, **k):
        out = orig(*a, **k)
        recorded.append(out)
        return out

    def loss_fn(p):
        recorded.clear()
        total, losses = compute_losses(tp.jmodel, tp.variables(p), batch, train=True)
        return total, (losses, list(recorded))

    jcrit.match_batch = recording
    try:
        (_, (losses, assignments)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tp.params)
    finally:
        jcrit.match_batch = orig
    want = {n: v.numpy() for n, v in jax_params_to_state_dict(grads).items()}
    case = (preset, port_config(tp.cfg), tp.port.state_dict(),
            {k: np.asarray(v) for k, v in batch.items()}, [np.asarray(a) for a in assignments])
    return case, {k: float(v) for k, v in losses.items()}, want


def test_ddp_step_matches_jax_at_the_global_batch():
    """(a): per preset, the global losses at LOSS_TOL relative and every
    trainable gradient at STEP_TOL of its scale against JAX's batch-2 step;
    a trainable parameter no rank's loss reaches (CAT's `w_noise` without
    noisy gating) has no gradient where JAX's is 0, and the repconvbn
    branch conv biases, 0 in exact arithmetic, are held at ZERO_GRAD_TOL of
    their weight gradient's scale; both ranks hold the same gradients."""
    refs = {p: _jax_step(p, ov) for p, ov in PRESETS}
    ranks = run_ranks(job_step, [refs[p][0] for p, _ in PRESETS])
    for preset, _ in PRESETS:
        _, want_losses, want = refs[preset]
        losses, grads = ranks[0][preset]
        assert sorted(losses) == sorted(want_losses), preset
        loss_err = {k: abs(losses[k] - v) / max(abs(v), 1e-30) for k, v in want_losses.items()}
        assert max(loss_err.values()) <= LOSS_TOL, (preset, loss_err)
        assert ranks[1][preset][0] == losses
        err, zero = {}, {}
        for n, g in grads.items():
            other = ranks[1][preset][1][n]
            assert (g is None) == (other is None) and (g is None or torch.equal(g, other)), n
            if g is None:
                assert not want[n].any(), (preset, n)
                continue
            g = g.numpy()
            if n.endswith("branch.conv.bias"):
                scale = np.abs(want[n.replace(".bias", ".weight")]).max()
                zero[n] = max(np.abs(g).max(), np.abs(want[n]).max()) / scale
                continue
            err[n] = np.abs(g - want[n]).max() / max(np.abs(want[n]).max(), 1e-30)
        assert len(zero) == (4 if preset == "repconvbngroundingdino" else 0)
        assert max(zero.values(), default=0.0) <= ZERO_GRAD_TOL, (preset, zero)
        assert max(err.values()) <= STEP_TOL, (preset, sorted(err.items(), key=lambda x: -x[1])[:5])
        if preset == "catgroundingdino":
            assert any(g is None for g in grads.values())  # w_noise


# ---------------------------------------------------------------------------
# (b) accumulation against optax.MultiSteps
# ---------------------------------------------------------------------------


def test_accumulation_matches_optax_multisteps():
    """(b): `batch_size_scale=2` over 4 calls with seeded gradients (a
    frozen leaf among them) against `optax.MultiSteps(every_k_schedule=2)`
    and the JAX step's EMA after every call: the parameters, the EMA, and
    the schedule's count after 2 and 4 calls; AdamW steps on calls 2 and 4
    only, and the parameters stay put between."""
    import jax.numpy as jnp
    import optax
    from tests.test_torch_train import _Tree, _t
    from ziragroundingdino_tpu.config import OptimizerConfig as JOpt
    from ziragroundingdino_tpu.config import ScheduleConfig as JSched
    from ziragroundingdino_tpu.train.optim import build_optimizer, trainable_mask

    rng = np.random.RandomState(5)
    params = {"base_w": rng.randn(4).astype(np.float32),
              "adapter_w": rng.randn(4, 3).astype(np.float32),
              "freeze_adapter_b": rng.randn(3).astype(np.float32)}
    grads = [{k: (s * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (0.01, 1.0, 0.05, 0.3)]
    opt_kw = dict(lr=1e-2, grad_clip=0.1, lr_factors=(("freeze", 0.2),))
    sched_kw = dict(max_iter=4, warmup_iter=1, milestones_frac=(0.5,))
    decay = 0.9

    tx = build_optimizer(JOpt(**opt_kw), JSched(**sched_kw), params,
                         trainable=trainable_mask(params, ("adapter",)), batch_size_scale=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ema = dict(jp)
    state = tx.init(jp)
    want = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        ema = {k: decay * ema[k] + (1.0 - decay) * jp[k] for k in ema}
        want.append(({k: np.asarray(v) for k, v in jp.items()},
                     {k: np.asarray(v) for k, v in ema.items()}, int(state.gradient_step)))

    model = _Tree(params)
    poptim.set_trainable(model, ("adapter",))
    opt = poptim.Optimizer(model, poptim.OptimizerConfig(**opt_kw),
                           poptim.ScheduleConfig(**sched_kw), ema_decay=decay, batch_size_scale=2)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, g in enumerate(grads):
        assert opt.will_update() == (i % 2 == 1)
        for k, p in model.named_parameters():  # a backward adds into .grad
            if p.requires_grad:
                p.grad = _t(g[k]).clone() if p.grad is None else p.grad + _t(g[k])
        opt.step()
        w_params, w_ema, w_count = want[i]
        if i % 2 == 0:
            for n, p in model.named_parameters():
                assert torch.equal(p.detach(), before[n]), (i, n)
        if i % 2 == 1:
            for n, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), w_params[n], rtol=OPT_TOL,
                                           atol=OPT_TOL, err_msg=f"call {i + 1}: {n}")
            for n, e in opt.ema.items():
                np.testing.assert_allclose(e.numpy(), w_ema[n], rtol=OPT_TOL, atol=OPT_TOL,
                                           err_msg=f"call {i + 1}: EMA {n}")
            assert opt.schedule.last_epoch == w_count == (i + 1) // 2
            assert opt.adamw.state[model.adapter_w]["step"].item() == w_count
            before = {n: p.detach().clone() for n, p in model.named_parameters()}


def test_accumulation_resumes_bitwise_between_updates():
    """A checkpoint taken after the first of two accumulated calls restores
    the accumulated gradients and the count: the next call's update is
    bitwise the uninterrupted run's."""
    from tests.test_torch_train import _Tree, _t

    rng = np.random.RandomState(6)
    params = {"base_w": rng.randn(4).astype(np.float32),
              "adapter_w": rng.randn(4, 3).astype(np.float32),
              "freeze_adapter_b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(2)]

    def build():
        m = _Tree(params)
        poptim.set_trainable(m, ("adapter",))
        return m, poptim.Optimizer(m, poptim.OptimizerConfig(lr=1e-2),
                                   poptim.ScheduleConfig(max_iter=4), ema_decay=0.9,
                                   batch_size_scale=2)

    def call(m, o, g):
        for k, p in m.named_parameters():
            if p.requires_grad:
                p.grad = _t(g[k]).clone() if p.grad is None else p.grad + _t(g[k])
        o.step()

    m1, o1 = build()
    call(m1, o1, grads[0])
    buf = io.BytesIO()
    torch.save({"model": m1.state_dict(), "optimizer": o1.state_dict()}, buf)
    call(m1, o1, grads[1])
    m2, o2 = build()
    buf.seek(0)
    ckpt = torch.load(buf, weights_only=True)
    m2.load_state_dict(ckpt["model"])
    o2.load_state_dict(ckpt["optimizer"])
    assert o2.mini_step == 1
    call(m2, o2, grads[1])
    for (n, a), (_, b) in zip(m1.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    for n in o1.ema:
        assert torch.equal(o1.ema[n], o2.ema[n]), n


# ---------------------------------------------------------------------------
# (c) the sharded eval
# ---------------------------------------------------------------------------

EVAL_SIZES = ((96, 128), (64, 96), (128, 96))  # eval buckets (96,128), (128,160), (128,160)


def _eval_split(root):
    """Three PPM images of EVAL_SIZES with seeded boxes and their COCO json."""
    from ziragroundingdino_torch.data.synthetic import write_ppm

    rng = np.random.RandomState(11)
    images, anns = [], []
    for i, (h, w) in enumerate(EVAL_SIZES):
        write_ppm(os.path.join(root, f"{i}.ppm"), rng.randint(0, 256, (h, w, 3), np.uint8))
        images.append({"id": i + 1, "file_name": f"{i}.ppm", "height": h, "width": w})
        for _ in range(2):
            bw, bh = rng.uniform(0.2, 0.5) * w, rng.uniform(0.2, 0.5) * h
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.randint(2)) + 1, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0})
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]}, f)
    return path


def _same_metrics(got, want, keys=None):
    """Every metric but the timings equal (NaN where there is no ground
    truth of a size equal too), over `keys` where given."""
    timing = {"sec_per_img", "images_per_sec"}
    if keys is None:
        keys = set(want) - timing
        assert set(got) - timing == keys
    np.testing.assert_equal({k: got[k] for k in keys}, {k: want[k] for k in keys})


def test_sharded_eval_matches_jax_and_one_process(tmp_path):
    """(c): 3 images at global batch 2 on two ranks: rank 0 runs images 0
    and 2, rank 1 image 1 and a copy of image 2 (`real_count` 0), each at
    its global batch's bucket; the detections of the 3 images in order
    against the one-process port's and JAX's at DET_TOL; every metric
    equal to the one-process port's and JAX's (on every rank); then the
    same through `eval_coco --mesh 2` against `eval_coco`."""
    from ziragroundingdino_tpu.eval import evaluator as jeval
    from ziragroundingdino_torch.scripts import eval_coco

    tp = TinyPair(seed=1)
    json_path = _eval_split(str(tmp_path))
    pcfg, sd = port_config(tp.cfg), tp.port.state_dict()
    torch.save({"model": sd}, tmp_path / "ckpt.pth")
    from ziragroundingdino_torch.data.synthetic import write_vocab

    write_vocab(str(tmp_path / "vocab.txt"), tiny_tokenizer().vocab)
    ov = tmp_path / "overrides.json"
    ov.write_text(json.dumps({"model": _model_overrides(pcfg), "data": EVAL_DATA}))
    script_args = ["--checkpoint", str(tmp_path / "ckpt.pth"), "--vocab",
                   str(tmp_path / "vocab.txt"), "--json", json_path, "--image-root",
                   str(tmp_path), "--batch-size", "2", "--config-overrides", str(ov),
                   "--select-k", str(SELECT_K), "--preset", "dualzerorepbranchgroundingdino",
                   "--device", "cpu"]

    one = build_model(pcfg, device="cpu", dtype="float32")
    one.load_state_dict(sd)
    record_one = []
    res_one, reals_one = port_eval(one, json_path, str(tmp_path), tiny_tokenizer().vocab,
                                   record_one)
    assert reals_one == [2, 1]

    # JAX on the one-process loader's batches
    from ziragroundingdino_torch.config import DataConfig
    from ziragroundingdino_torch.data.coco import CocoDataset
    from ziragroundingdino_torch.data.loader import DataLoader
    from ziragroundingdino_torch.text.tokenizer import WordPieceTokenizer

    ds = CocoDataset.from_json(json_path, str(tmp_path))
    batches = list(DataLoader(ds, WordPieceTokenizer(tiny_tokenizer().vocab),
                              DataConfig(**EVAL_DATA), batch_size=2, train=False,
                              max_text_len=32, max_categories=8))
    jfn = jeval.make_inference_fn(tp.jmodel, select_k=SELECT_K)
    record_jax = []

    def jax_recording(params, batch):
        det = jfn(params, batch)
        record_jax.append({k: np.asarray(v) for k, v in det.items()})
        return det

    res_jax = jeval.inference_on_dataset(tp.variables(), iter([dict(b) for b in batches]),
                                         jax_recording, num_classes=2, num_warmup=0,
                                         class_names=ds.category_names)

    ranks = run_ranks(job_eval, pcfg, sd, json_path, str(tmp_path), tiny_tokenizer().vocab,
                      script_args)
    assert [r[1] for r in ranks] == [[1, 1], [1, 0]]
    for r in ranks:
        _same_metrics(r[0], res_one)
    # image order: batch 0 = (rank 0, rank 1), batch 1 = rank 0's image 2
    sharded = [ranks[0][2][0], ranks[1][2][0], ranks[0][2][1]]
    for i, (b, row) in enumerate(((0, 0), (0, 1), (1, 0))):
        for k in ("scores", "labels", "boxes"):
            got = sharded[i][k][0]
            np.testing.assert_allclose(got, record_one[b][k][row], atol=DET_TOL,
                                       err_msg=f"image {i} {k} vs one process")
            np.testing.assert_allclose(got, record_jax[b][k][row], atol=DET_TOL,
                                       err_msg=f"image {i} {k} vs JAX")
    assert res_one["n_images"] == 3
    _same_metrics(res_one, res_jax, set(res_jax) - {"sec_per_img", "images_per_sec"})

    script_one = eval_coco.main(script_args)
    _same_metrics(script_one, res_one)
    for r in ranks:
        _same_metrics(r[3], script_one)


def _model_overrides(pcfg):
    """The config fields an overrides json carries for `pcfg` (the tiny
    config's, as `load_config_overrides` reads them)."""
    from ziragroundingdino_torch.config import GroundingDINOConfig, get_model_config

    base = get_model_config("dualzerorepbranchgroundingdino")
    ov = {}
    for f in dataclasses.fields(GroundingDINOConfig):
        v = getattr(pcfg, f.name)
        if v != getattr(base, f.name):
            ov[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
    return ov


# ---------------------------------------------------------------------------
# (d) train_odinw, --mesh 2 against --mesh 1
# ---------------------------------------------------------------------------


def test_train_odinw_mesh2_matches_mesh1(tmp_path, monkeypatch):
    """(d): `train_odinw` on two synthetic tasks, 1 step a task at global batch
    2, the replay and the sharded eval, with dropout off and one image
    bucket (a sharded train loader pads to the largest bucket, as the JAX
    package's does: with one bucket both runs pad alike): every chained
    tensor of both tasks at STATE_TOL of --mesh 1's, the same report; rank
    0 alone wrote the checkpoints, each rank its log."""
    from tests.test_torch_trainer import TASKS, TINY_MODEL
    from ziragroundingdino_torch.config import load_config_overrides
    from ziragroundingdino_torch.data.synthetic import write_odinw_task, write_vocab
    from ziragroundingdino_torch.scripts import train_odinw

    data = dict(EVAL_DATA, shape_buckets=((160, 224),))
    ov = tmp_path / "overrides.json"
    ov.write_text(json.dumps({"model": TINY_MODEL, "data": data}))
    model = build_model("dualzerorepbranchgroundingdino", device="cpu", seed=0,
                        **load_config_overrides(str(ov))[0])
    torch.save({"model": model.state_dict()}, tmp_path / "ckpt.pth")
    write_vocab(str(tmp_path / "vocab.txt"), tiny_tokenizer().vocab)
    for i, (name, classes) in enumerate(TASKS.items()):
        write_odinw_task(str(tmp_path / "data"), name, classes, 4, 3, (96, 128), seed=10 * i)

    def args(out):
        return ["--checkpoint", str(tmp_path / "ckpt.pth"), "--vocab", str(tmp_path / "vocab.txt"),
                "--datasets-root", str(tmp_path / "data"), "--tasks", ",".join(TASKS),
                "--output-dir", str(tmp_path / out), "--batch-size", "2", "--max-iter", "1",
                "--checkpoint-period", "1", "--replay-iters", "1",
                "--config-overrides", str(ov), "--device", "cpu"]

    reports = run_ranks(job_train_odinw, args("mesh2"))
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    for k in ("RANK", "LOCAL_RANK"):
        monkeypatch.setenv(k, "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    report1 = train_odinw.main(args("mesh1") + ["--mesh", "1"])
    assert not pdist.is_initialized()
    assert reports[0] == reports[1] == report1

    for name in TASKS:
        got = torch.load(tmp_path / "mesh2" / name / "state_final.pt", weights_only=True)
        want = torch.load(tmp_path / "mesh1" / name / "state_final.pt", weights_only=True)
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, atol=STATE_TOL, rtol=0,
                                       msg=lambda m, k=k: f"{name} {k}: {m}")
        assert sorted(got["prompt_memory"]) == sorted(want["prompt_memory"])
    out = tmp_path / "mesh2"
    assert sorted(os.listdir(out / "pothole" / "ckpt")) == ["last_checkpoint", "step_1.pt"]
    assert (out / "log.txt").exists() and (out / "log.rank1.txt").exists()
    assert not (tmp_path / "mesh1" / "log.rank1.txt").exists()


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop_last", [True, False])
def test_shard_indices_match_jax(drop_last, monkeypatch):
    """`shard_indices_for_process` index for index the JAX package's, for
    every rank of 1-4 processes over 0-9 items, shuffled and not."""
    from ziragroundingdino_tpu.parallel import multihost

    for count in range(1, 5):
        for rank in range(count):
            monkeypatch.setattr(multihost, "process_count", lambda c=count: c)
            monkeypatch.setattr(multihost, "process_index", lambda r=rank: r)
            monkeypatch.setattr(pdist, "process_count", lambda c=count: c)
            monkeypatch.setattr(pdist, "process_index", lambda r=rank: r)
            for n in range(10):
                for shuffle in (True, False):
                    kw = dict(seed=3, epoch=n % 3, shuffle=shuffle, drop_last=drop_last)
                    np.testing.assert_array_equal(
                        pdist.shard_indices_for_process(n, **kw),
                        multihost.shard_indices_for_process(n, **kw))
            assert pdist.local_batch_size(4 * count) == 4
            if count > 1:
                with pytest.raises(ValueError, match="not divisible"):
                    pdist.local_batch_size(4 * count + 1)


def test_one_process_is_the_identity():
    """Without a process group the collectives are the identity, bitwise."""
    x = torch.tensor([0.0, 2.5, 7.0], requires_grad=True)
    assert pdist.all_reduce_sum(x) is x
    assert torch.equal(pdist.global_divisor(torch.tensor(0.0)), torch.tensor(1.0))
    assert torch.equal(pdist.global_divisor(torch.tensor(5.0)), torch.tensor(5.0))
    m = {"a": torch.tensor(1.5)}
    assert pdist.mean_over_ranks(m) is m
    assert pdist.gather_to_rank0(3) == [3] and pdist.broadcast_object(4) == 4
    assert pdist.process_count() == 1 and pdist.process_index() == 0


def test_make_mesh_and_the_scripts_refuse_what_is_not_ported(tmp_path, monkeypatch):
    """`make_mesh` refuses sizes whose product is not the process count,
    naming the launch it expected (a pipe axis too, which no driver flag
    takes: its message names `make_mesh`); one process makes a mesh of one
    rank on every axis. The scripts exit with those messages, not a
    traceback, and refuse a batch that the data axis does not divide;
    `train_odinw --mesh` takes three fields, `eval_coco`'s the data axis
    alone, as the JAX package's; the driver's help names the pipeline's
    API."""
    from ziragroundingdino_torch.scripts import eval_coco, train_odinw

    for sizes in ((1,), (-1,)):
        m = pmesh.make_mesh(*sizes)
        assert (m.data, m.model, m.seq, m.pipe) == (1, 1, 1, 1) and m.boundaries == []
        assert all(size == 1 for _, size, _ in m.axes.values())
    pdist.set_mesh(None)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        pmesh.make_mesh(2)
    for kw in (dict(model=2), dict(seq=2)):
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 .* --mesh 1,"):
            pmesh.make_mesh(1, **kw)
    with pytest.raises(ValueError, match=r"torchrun --nproc-per-node 2 .*make_mesh\(data=1, "
                       r"model=1, seq=1, pipe=2\)"):
        pmesh.make_mesh(1, pipe=2)
    assert pmesh.parse_mesh("4") == (4, 1, 1) and pmesh.parse_mesh("2,2,1") == (2, 2, 1)
    for bad in ("0", "1,2,3,4", "1,1,1,2", "a"):
        with pytest.raises(ValueError):
            pmesh.parse_mesh(bad)

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    common = ["--checkpoint", "x.pth", "--vocab", "v.txt", "--device", "cpu"]
    train = common + ["--output-dir", str(tmp_path), "--batch-size", "2"]
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 4 .* --mesh 1,2,2"):
        train_odinw.main(train + ["--mesh", "1,2,2"])
    with pytest.raises(SystemExit, match="data axis alone"):
        eval_coco.main(common + ["--json", "a.json", "--image-root", ".", "--mesh", "2,1,2"])
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        train_odinw.main(train + ["--mesh", "2"])
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(SystemExit, match="divisible by the data axis 4"):
        train_odinw.main(train + ["--batch-size", "2", "--mesh", "4"])
    with pytest.raises(SystemExit, match="divisible by the data axis 3"):
        train_odinw.main(train + ["--batch-size", "2", "--mesh", "3,2,1"])
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        eval_coco.main(common + ["--json", "a.json", "--image-root", ".", "--mesh", "2"])
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    with pytest.raises(SystemExit, match="needs 2 processes but this one is 1 of 1"):
        train_odinw.main(train + ["--mesh", "1,2"])
    assert not pdist.is_initialized() and pdist.current_mesh() is None
    assert "pipeline_parallel" in train_odinw.EPILOG and "data[,model[,seq]]" in train_odinw.EPILOG
    with pytest.raises(SystemExit, match="--mesh 1,1,1,2"):
        train_odinw.main(train + ["--mesh", "1,1,1,2"])


def test_rank_generators_and_the_eval_hook(tmp_path):
    """Rank 0 draws the one-process stream, rank 1 another; the trainer
    calls `eval_fn` with the model every `eval_period` iterations and keeps
    its results, as the JAX trainer's hook."""
    from tests.test_torch_trainer import _Tiny
    from ziragroundingdino_torch.config import TrainConfig
    from ziragroundingdino_torch.train.trainer import Trainer, iteration_generator

    cpu = torch.device("cpu")
    draw = [torch.rand(4, generator=iteration_generator(7, 3, cpu, r)) for r in (0, 0, 1, 2)]
    state = np.random.SeedSequence([7, 3]).generate_state(1, np.uint64)[0]
    assert torch.equal(draw[0], torch.rand(4, generator=torch.Generator().manual_seed(
        int(state) & (2**63 - 1))))
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2]) and not torch.equal(draw[2], draw[3])

    m = _Tiny()
    seen = []

    def step_fn(model, optimizer, batch, generator):
        return {"total_loss": torch.tensor(float(batch["x"]))}

    def eval_fn(model):
        seen.append(model)
        return {"AP": float(len(seen))}

    def batches():
        i = 0
        while True:
            yield {"x": np.asarray(i)}
            i += 1

    cfg = TrainConfig(output_dir=str(tmp_path), max_iter=5, checkpoint_period=100,
                      eval_period=2, log_period=1)
    tr = Trainer(m, poptim.Optimizer(m), batches(), cfg, step_fn=step_fn, eval_fn=eval_fn)
    tr.train()
    assert tr.eval_results == [(2, {"AP": 1.0}), (4, {"AP": 2.0})] and seen == [m, m]
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["total_loss"] for x in lines] == [0.0, 1.0, 2.0, 3.0, 4.0]


def test_io_and_events_match_jax(tmp_path):
    """`load` / `dump` read what JAX's write and write what JAX's read (json,
    pickle); `setup_logger` writes rank 0 to the console and `log.txt`,
    rank r to `log.rank{r}.txt` only, as JAX's; `CommonMetricPrinter` and
    `print_csv_format` log the lines JAX's log; the optional writers are
    no-ops without their packages."""
    from ziragroundingdino_tpu.utils import events as jevents
    from ziragroundingdino_tpu.utils import io as jio
    from ziragroundingdino_torch.utils import events as pevents
    from ziragroundingdino_torch.utils import io as pio

    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    for ext in (".json", ".pkl"):
        pio.dump(obj, str(tmp_path / f"p{ext}"))
        jio.dump(obj, str(tmp_path / f"j{ext}"))
        assert jio.load(str(tmp_path / f"p{ext}")) == pio.load(str(tmp_path / f"j{ext}")) == obj
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    with pytest.raises(ValueError, match="unsupported"):
        pio.load(str(tmp_path / "x.txt"))

    for rank in (0, 1):
        d = tmp_path / f"port{rank}"
        lg = pio.setup_logger(str(d), name=f"ddp_test_port_{rank}", rank=rank)
        jlg = jio.setup_logger(str(tmp_path / f"jax{rank}"), name=f"ddp_test_jax_{rank}",
                               rank=rank)
        assert ([type(h).__name__ for h in lg.handlers]
                == [type(h).__name__ for h in jlg.handlers])
        lg.info("hello")
        for h in lg.handlers:
            h.flush()
        assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path / f"jax{rank}"))
        assert "hello" in (d / os.listdir(d)[0]).read_text()
        lg2 = pio.setup_logger(str(tmp_path / f"again{rank}"), name=f"ddp_test_port_{rank}",
                               rank=rank)
        assert len(lg2.handlers) == len(jlg.handlers)

    def lines(logger_name, fn):
        stream = io.StringIO()
        h = logging.StreamHandler(stream)
        lg = logging.getLogger(logger_name)
        level = lg.level
        lg.addHandler(h)
        lg.setLevel(logging.INFO)
        try:
            fn()
        finally:
            lg.removeHandler(h)
            lg.setLevel(level)
        return [x.split(" iter_time")[0] for x in stream.getvalue().splitlines()]

    metrics = {"total_loss": 1.25, "loss_bbox": 0.5, "n": 3}
    results = {"task": {"AP": 12.5, "AP50": 30.0, "n": 3}}
    got = lines("ziragroundingdino_torch", lambda: (
        pevents.CommonMetricPrinter(10).write(2, metrics), pevents.print_csv_format(results)))
    want = lines("ziragroundingdino_tpu", lambda: (
        jevents.CommonMetricPrinter(10).write(2, metrics), jevents.print_csv_format(results)))
    assert got == want and len(got) == 4
    w = pevents.TensorboardWriter(str(tmp_path / "tb"))
    w.write(1, metrics)
    w.close()
