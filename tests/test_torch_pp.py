"""Pipeline parallelism (`parallel/pp.py`, the pipe axis of
`parallel/mesh.py`) on the CPU, over gloo ranks (`tests/torch_ranks.py`,
whose rank jobs import no JAX), f32, at the tiny config with four encoder
layers (as `tests/test_pp.py`), microbatches 2:

  * the ZiRa forward and train step under `make_mesh` with pipe 2, pipe 4
    (one layer a stage), data 2 x pipe 2 (a global batch of 4) and model 2
    x pipe 2, and CAT's (whose in-layer adapters are stage-owned and whose
    adapter loss crosses the stages) under pipe 2 and model 2 x pipe 2,
    against JAX's `pp.pipeline_parallel` on a JAX mesh of the same shape
    (the matcher pinned to the port's one process's assignments in both):
    detections at JAX_TOL abs, every loss and trainable gradient at
    JAX_TOL of its scale;
  * the same, CAT under data 2 x pipe 2 (its stage-owned adapters'
    gradients through DDP's hooks), and steps with every dropout on, remat
    on and off (one generator, drawn as in one process), against the
    port's one process at PORT_TOL;
  * each rank runs its own stage's layers alone, once a microbatch, and
    the transfers between stages happen (the counterpart of JAX's
    `test_pp_actually_pipelines`); ranks sit at JAX's mesh coordinates;
  * the replicated and stage-owned trainable weights stay bitwise alike
    over the pipe axis after AdamW steps whose gradients were moved apart
    on each rank;
  * CAT under pipe 2 with `batch_size_scale` 2: the gradients that a
    checkpoint between the two calls holds and those that the update
    applies, against the port's one process at PORT_TOL (each call's
    stage-owned gradients counted once);
  * the refusals, with JAX's messages: seq with pipe, `enc_layers % pipe`,
    the batch by the microbatches.
"""

import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pet import preset_overrides
from tests.test_torch_tp_sp import _batch, _check_step, _err, _recorded
from tests.test_train_step import make_batch
from tests.torch_common import TinyPair, port_config
from tests.torch_ranks import accumulate_run, job_pp, pipe_run, run_ranks
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.parallel import mesh as pmesh
from ziragroundingdino_torch.parallel import pp, sp
from ziragroundingdino_torch.train import step as pstep
from ziragroundingdino_torch.weights import jax_params_to_state_dict

JAX_TOL = 1e-4  # detections (abs), losses and gradients (of their scale) against JAX
PORT_TOL = 1e-5  # the same, of each tensor's scale, against the port's one process
MICRO = 2
ENC_LAYERS = 4
MESHES = {"pipe2": (1, 1, 2), "pipe4": (1, 1, 4), "data2_pipe2": (2, 1, 2),
          "model2_pipe2": (1, 2, 2)}  # (data, model, pipe)
DROPOUT = dict(dropout=0.1, text_dropout=0.1, fusion_dropout=0.1, fusion_droppath=0.1)
REMAT = dict(use_checkpoint=True, use_transformer_ckpt=True)
DROPOUT_SEED = 3
# each mesh's cases; "zira4" and "cat4" are at a global batch of 4 (CAT's
# stage-owned adapters then take their gradients through DDP's hooks)
CASES = {"pipe2": ("zira", "cat", "dropout", "dropout_remat"),
         "pipe4": ("zira", "dropout_remat"),
         "data2_pipe2": ("zira4", "cat4"),
         "model2_pipe2": ("zira", "cat", "dropout_remat")}
AGAINST_JAX = [("pipe2", "zira"), ("pipe4", "zira"), ("data2_pipe2", "zira4"),
               ("model2_pipe2", "zira"), ("pipe2", "cat"), ("model2_pipe2", "cat")]
REPLICAS = {"pipe2": "cat", "model2_pipe2": "cat"}
ACCUMULATE = {"pipe2": "cat4"}  # its global batch of 4 in two calls of 2
RANKS_TIMEOUT = 900  # s; the four meshes' rank runs take ~40 s on one worker


def _jax_pp(tp, batch, sizes, rows):
    """JAX's eval detections and its step's losses and gradients (the port's
    names) under `pp.pipeline_parallel(make_mesh(data, model, pipe) of the
    first CPU devices, microbatches=MICRO)`, the parameters and the batch
    placed by `param_sharding` and `batch_sharding`, the matcher pinned to
    `rows` ([outputs * B, N], output by output)."""
    from ziragroundingdino_tpu.parallel import pp as jpp
    from ziragroundingdino_tpu.parallel.mesh import batch_sharding, make_mesh, param_sharding
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train.step import compute_losses

    data, model, pipe = sizes
    mesh = make_mesh(data=data, model=model, pipe=pipe,
                     devices=jax.devices()[:data * model * pipe])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb = jax.device_put(jb, batch_sharding(jb, mesh))
    params = jax.device_put(tp.params, param_sharding(tp.params, mesh))
    text = {k: jb[k] for k in pstep.TEXT_KEYS}
    b = len(batch["pixels"])
    chunks = np.asarray(rows, np.int32).reshape(-1, b, rows.shape[-1])

    def loss_fn(p):
        pinned = iter(chunks)
        orig, jcrit.match_batch = jcrit.match_batch, lambda *a, **k: jnp.asarray(next(pinned))
        try:
            return compute_losses(tp.jmodel, tp.variables(p), jb, train=True)
        finally:
            jcrit.match_batch = orig

    with jpp.pipeline_parallel(mesh, microbatches=MICRO):
        fwd = jax.jit(lambda p: tp.jmodel.apply({"params": p}, jb["pixels"], jb["mask"],
                                                text))(params)
        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return ({k: np.asarray(fwd[k]) for k in ("pred_logits", "pred_boxes")},
            {k: float(v) for k, v in losses.items()},
            {n: v.numpy() for n, v in jax_params_to_state_dict(grads).items()})


def _one_process(pcfg, sd, batch, seed=None):
    """The port's one process: the assignments that its matcher chooses in
    the step's losses (the same generator), then `pipe_run` (no mesh)
    replaying them, as every rank does. Returns (the run, the assignments)."""
    def losses():
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            pstep.compute_losses(model, t, gen)

    _, seen = _recorded(losses)
    rows = np.concatenate(seen)
    model = build_model(pcfg, device="cpu", dtype="float32")
    model.load_state_dict(sd)
    return pipe_run(model, pcfg, batch, rows, seed), rows


@pytest.fixture(scope="module")
def runs():
    """The port's one-process runs of every case, the four meshes' rank runs
    (in a thread of their own, the ranks being processes) and, meanwhile,
    JAX's pipelined forwards and steps."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    zira = TinyPair(seed=1, enc_layers=ENC_LAYERS)
    cat = TinyPair(seed=2, enc_layers=ENC_LAYERS,
                   **preset_overrides("catgroundingdino", num_experts=4, num_topk_experts=2))
    zcfg, zsd = port_config(zira.cfg), zira.port.state_dict()
    ccfg, csd = port_config(cat.cfg), cat.port.state_dict()
    batch2 = _batch()
    batch4 = {k: np.asarray(v) for k, v in make_batch(b=4).items()}
    drop = dataclasses.replace(zcfg, **DROPOUT)
    drop_remat = dataclasses.replace(drop, **REMAT)
    inputs = {"zira": (zcfg, zsd, batch2, None), "zira4": (zcfg, zsd, batch4, None),
              "cat": (ccfg, csd, batch2, None), "cat4": (ccfg, csd, batch4, None),
              "dropout": (drop, zsd, batch2, DROPOUT_SEED),
              "dropout_remat": (drop_remat, zsd, batch2, DROPOUT_SEED)}
    one, rows = {}, {}
    for label, (pcfg, sd, batch, seed) in inputs.items():
        one[label], rows[label] = _one_process(pcfg, sd, batch, seed)
    acc_one = {}
    for label in set(ACCUMULATE.values()):
        pcfg, sd, batch, _ = inputs[label]
        model = build_model(pcfg, device="cpu", dtype="float32")
        model.load_state_dict(sd)
        acc_one[label] = accumulate_run(model, pcfg, batch, rows[label])

    ranks, failed = {}, []

    def rank_runs():
        try:
            for name, sizes in MESHES.items():
                def case(label):
                    pcfg, sd, batch, seed = inputs[label]
                    return label, pcfg, sd, batch, rows[label], seed

                acc = case(ACCUMULATE[name]) if name in ACCUMULATE else None
                ranks[name] = run_ranks(job_pp, sizes, MICRO, [case(c) for c in CASES[name]],
                                        REPLICAS.get(name), acc, world=int(np.prod(sizes)))
        except Exception as e:  # raised in the test's thread below
            failed.append(e)

    thread = threading.Thread(target=rank_runs)
    thread.start()
    pairs = {"zira": zira, "zira4": zira, "cat": cat}
    try:
        jax_ref = {(name, label): _jax_pp(pairs[label], inputs[label][2], MESHES[name],
                                          rows[label])
                   for name, label in AGAINST_JAX}
    finally:
        thread.join(timeout=RANKS_TIMEOUT)
    assert not thread.is_alive(), f"the rank runs took over {RANKS_TIMEOUT} s"
    if failed:
        raise failed[0]
    return dict(jax=jax_ref, one=one, ranks=ranks, acc_one=acc_one)


def _ranks(runs, mesh):
    return runs["ranks"][mesh]


@pytest.mark.parametrize("mesh,case", AGAINST_JAX)
def test_forward_and_step_match_jax(runs, mesh, case):
    """Every rank's detections (JAX_TOL abs; the top-k queries those of the
    port's one process), losses and trainable gradients (JAX_TOL of their
    scale) against JAX's pipelined forward and step on a mesh of the same
    shape; a data rank's detections are its rows of JAX's."""
    jfwd, jlosses, jgrads = runs["jax"][mesh, case]
    data = MESHES[mesh][0]
    assert np.abs(jfwd["pred_boxes"] - 0.5).max() > 1e-3  # boxes off their anchors
    for results, (d, p, m), *_ in _ranks(runs, mesh):
        logits, boxes, topk, losses, grads = results[case][:5]
        b = len(jfwd["pred_logits"]) // data
        rows = slice(d * b, (d + 1) * b)
        want_logits = jfwd["pred_logits"][rows]
        valid = np.abs(want_logits) < 1e6
        assert np.abs(logits.numpy() - want_logits)[valid].max() <= JAX_TOL, (d, p, m)
        assert _err(boxes, jfwd["pred_boxes"][rows], of_scale=False) <= JAX_TOL, (d, p, m)
        assert torch.equal(topk, runs["one"][case][2][rows]), (d, p, m)
        _check_step(losses, grads, jlosses, jgrads, JAX_TOL, f"{mesh} {case} rank {(d, p, m)}")


@pytest.mark.parametrize("mesh,case", [(mesh, case) for mesh, cases in CASES.items()
                                       for case in cases])
def test_pipelined_run_matches_one_process(runs, mesh, case):
    """Every rank against the port's one process at PORT_TOL: detections,
    losses and trainable gradients, with dropout on (one generator; the
    masks move the losses) and remat on and off; every rank's losses
    alike."""
    want = runs["one"][case]
    if case.startswith("dropout"):
        assert abs(want[3]["total_loss"] - runs["one"]["zira"][3]["total_loss"]) > 1e-3
    data = MESHES[mesh][0]
    results = [(r[0][case], r[1]) for r in _ranks(runs, mesh)]
    for (logits, boxes, _, losses, grads, *_), (d, p, m) in results:
        b = len(want[0]) // data
        rows = slice(d * b, (d + 1) * b)
        assert _err(logits, want[0][rows]) <= PORT_TOL, (d, p, m)
        assert _err(boxes, want[1][rows]) <= PORT_TOL, (d, p, m)
        _check_step(losses, grads, want[3], want[4], PORT_TOL, f"{mesh} {case} {(d, p, m)}")
        assert losses == results[0][0][3]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_runs_its_stage(runs, mesh):
    """Anti-vacuity: in the eval forward each rank ran its own stage's
    layers alone, chunk * M calls, and joined M transfers a neighbouring
    stage and one broadcast of the outputs; a train step twice that (the
    backward's transfers and stage 0's input gradients). The ranks sit at
    JAX's coordinates, global rank ((d * pipe + p) * seq + s) * model + m."""
    data, model, pipe = MESHES[mesh]
    chunk = ENC_LAYERS // pipe
    coords = []
    for r, (results, (d, p, m), *_) in enumerate(_ranks(runs, mesh)):
        assert r == (d * pipe + p) * model + m
        coords.append((d, p, m))
        own = list(range(p * chunk, (p + 1) * chunk))
        neighbours = (p > 0) + (p < pipe - 1)
        for case, res in results.items():
            calls, counts, step_counts = res[5:8]
            assert calls == own * MICRO, (case, r, calls)
            assert counts == {"boundary": MICRO * neighbours, "pipe": 1, "grads": 0}, (
                case, r, counts)
            # CAT trains its in-layer adapters, the ZiRa cases no encoder layer
            stage_trained = int(case.startswith("cat"))
            assert step_counts == {"boundary": 2 * MICRO * neighbours, "pipe": 2,
                                   "grads": stage_trained}, (case, r, step_counts)
    assert sorted(coords) == [(d, p, m) for d in range(data) for p in range(pipe)
                              for m in range(model)]


@pytest.mark.parametrize("mesh", list(REPLICAS))
def test_pipe_ranks_keep_one_copy_of_the_weights(runs, mesh):
    """Two AdamW steps of CAT with each pipe rank's gradients moved apart
    before the optimizer: the replicated gradients differed over the pipe
    axis, and after the optimizer's reduction (the stage-owned adapters'
    gradients summed, the rest averaged) every trainable weight is bitwise
    alike over it and every rank's `state_dict()` is the same."""
    digests = set()
    for _, _, (differed, same, digest), _ in _ranks(runs, mesh):
        assert differed and same
        digests.add(digest)
    assert len(digests) == 1


@pytest.mark.parametrize("mesh", list(ACCUMULATE))
def test_accumulation_matches_one_process(runs, mesh):
    """`batch_size_scale` 2 under the pipe axis: after the first call the
    gradients a checkpoint holds, after the second the mean gradient the
    update applies, on every rank against the port's one process at
    PORT_TOL of their scale; a stage-owned adapter's gradient counts each
    call once (the pipe sum is taken in the backward, not in the
    optimizer's every call)."""
    want_held, want_applied = runs["acc_one"][ACCUMULATE[mesh]]
    assert any("adapter" in n and ".encoder.layers." in n for n in want_applied)
    for _, coords, _, (held, applied) in _ranks(runs, mesh):
        assert sorted(held) == sorted(want_held) and sorted(applied) == sorted(want_applied)
        for got, want in ((held, want_held), (applied, want_applied)):
            for n, g in got.items():
                assert _err(g, want[n]) <= PORT_TOL, (coords, n, _err(g, want[n]))


def _fake_mesh(**sizes):
    """A `parallel.mesh.Mesh` of these sizes with no process group: enough
    for the refusals, which come before any collective."""
    m = pmesh.Mesh(**sizes)
    m.axes = {k: (None, getattr(m, k, 1), 0) for k in ("data", "pipe", "seq", "model")}
    return m


def test_refusals_with_jax_messages():
    """seq together with pipe (under both contexts), `enc_layers % pipe`
    and a local batch that the microbatches do not divide are refused in
    the port's forward as in JAX's, with JAX's messages; a mesh without a
    pipe axis is refused by the context."""
    from ziragroundingdino_tpu.parallel import pp as jpp
    from ziragroundingdino_tpu.parallel import sp as jsp
    from ziragroundingdino_tpu.parallel.mesh import make_mesh

    tp = TinyPair(seed=1, enc_layers=ENC_LAYERS)
    b3 = {k: np.asarray(v) for k, v in make_batch(b=3).items()}

    def port(batch, mesh, micro=None, seq=False):
        t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        ctx = sp.sequence_parallel(mesh) if seq else contextlib.nullcontext()
        with pytest.raises((AssertionError, ValueError)) as e:
            with ctx, pp.pipeline_parallel(mesh, micro), torch.no_grad():
                tp.port(t["pixels"], t["mask"], {k: t[k] for k in pstep.TEXT_KEYS})
        return e.type, str(e.value)

    def jax_side(batch, mesh, micro=None, seq=False):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        text = {k: jb[k] for k in pstep.TEXT_KEYS}
        ctx = jsp.sequence_parallel(mesh) if seq else contextlib.nullcontext()
        with pytest.raises((AssertionError, ValueError)) as e:
            with ctx, jpp.pipeline_parallel(mesh, microbatches=micro):
                jax.eval_shape(lambda p: tp.jmodel.apply({"params": p}, jb["pixels"],
                                                         jb["mask"], text), tp.params)
        return e.type, str(e.value)

    batch2 = _batch()
    cases = [
        (batch2, dict(seq=2, pipe=2), dict(data=1, seq=2, pipe=2), None, True,
         "mutually exclusive"),
        (batch2, dict(pipe=3), dict(data=1, pipe=3), None, False,
         f"enc_layers={ENC_LAYERS} not divisible by pipe=3"),
        (b3, dict(pipe=2), dict(data=1, pipe=2), MICRO, False,
         "batch 3 not divisible by microbatches=2"),
    ]
    for batch, port_sizes, jax_sizes, micro, seq, words in cases:
        n = int(np.prod(list(jax_sizes.values())))
        jmesh = make_mesh(**jax_sizes, devices=jax.devices()[:n])
        got, want = port(batch, _fake_mesh(**port_sizes), micro, seq), jax_side(
            batch, jmesh, micro, seq)
        assert got == want and words in got[1], (got, want)
    with pytest.raises(ValueError, match="has no 'pipe' axis"):
        with pp.pipeline_parallel(pmesh.Mesh()):
            pass
    assert pp.active() is None
