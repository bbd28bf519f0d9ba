"""The exact assignment on the device, `ops/lsap.py`, against the JAX
package's `train/matcher.py::lsap_jax` (the JAX train step's default
matcher) on the CPU.

`lsap_plain` runs `lsap_jax`'s loops with its f32 expressions, so the
assignments are equal, ties included, on costs made from a numpy seed:
uniform f32, integer-valued (many ties), `BIG` columns of invalid targets
(as the lifecycle pads its targets), constant target columns, columns of
+0.0 and -0.0, N = 1 and N = Q. The total cost equals scipy's. Then the set criterion
with the port's default matcher against JAX's default
(`set_criterion(matcher_impl="jax")`, its costs computed eagerly) on the
tiny model's train-mode outputs: every loss at 1e-4, the assignments
equal. The wrapper refuses what the kernel does not take, and its launch
plan covers every Q it takes within a block's shared memory; on a card
(`cuda` marker) the kernel returns the plain version's assignments
exactly, with rows that overflow shared memory and problems that are not
finite too:

    python -m pytest --noconftest -m cuda tests/test_torch_lsap.py
"""

import numpy as np
import pytest
import torch

from ziragroundingdino_torch.ops import lsap as plsap
from ziragroundingdino_torch.train import criterion as pcrit
from ziragroundingdino_torch.train import matcher as pmatch

LOSS_TOL = 1e-4  # the train step's parity (tests/test_torch_train.py::STEP_TOL)


@pytest.fixture(scope="module")
def tiny_pair():
    from tests.torch_common import TinyPair  # imports JAX: not on the card

    return TinyPair()


def _costs(case: str, p: int = 6, q: int = 12, n: int = 5) -> np.ndarray:
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "uniform":
        return rng.rand(p, q, n).astype(np.float32)
    if case == "integers":  # values 0..3: many equal costs and equal paths
        return rng.randint(0, 4, (p, q, n)).astype(np.float32)
    if case == "big_columns":  # the last 3 targets invalid, as the matcher pads them
        cost = rng.rand(p, q, n + 3).astype(np.float32)
        cost[:, :, n:] = pmatch.BIG
        return cost
    if case == "one_target":
        return rng.rand(p, q, 1).astype(np.float32)
    if case == "square":  # N = Q: every query taken
        return rng.rand(p, q, q).astype(np.float32)
    if case == "square_integers":
        return rng.randint(0, 3, (p, q, q)).astype(np.float32)
    if case == "matcher_scale":  # the train step's Q and a ragged N
        return (10.0 * rng.rand(p, 900, 7)).astype(np.float32)
    if case == "padded":  # 3 valid targets of 10, as the loader pads to max_boxes
        cost = rng.rand(p, 12, 10).astype(np.float32)
        cost[:, :, 3:] = pmatch.BIG
        return cost
    if case == "constant_rows":  # targets whose costs are one ordinary value
        cost = rng.rand(p, q, n).astype(np.float32)
        cost[:, :, 1] = cost[:, :, 3] = 0.5
        cost[:, :, 4] = 0.25
        return cost
    if case == "signed_zero":  # +0.0 and -0.0 in a column, and in others among ties
        cost = rng.randint(0, 3, (p, q, n)).astype(np.float32)
        cost[:, :, 0] = 0.0
        cost[(cost == 0) & (rng.rand(p, q, n) < 0.5)] = -0.0
        return cost
    # on the card only (the plain version is the reference there)
    if case == "almost_constant":  # a BIG row but for one entry
        cost = rng.rand(p, q, n).astype(np.float32)
        cost[:, :, 2] = pmatch.BIG
        cost[:, 5, 2] = 3.0
        return cost
    if case == "dense_overflow":  # 100 varying rows of 900: beyond shared memory
        return (10.0 * rng.rand(p, 900, 100)).astype(np.float32)
    if case == "overflow_after_constant":  # constant rows in slots, varying rows beyond
        cost = (10.0 * rng.rand(p, 900, 100)).astype(np.float32)
        cost[:, :, :30] = pmatch.BIG
        return cost
    raise ValueError(case)


CASES = ("uniform", "integers", "big_columns", "one_target", "square", "square_integers",
         "matcher_scale", "padded", "constant_rows", "signed_zero")
CARD_CASES = CASES + ("almost_constant", "dense_overflow", "overflow_after_constant")


@pytest.mark.parametrize("case", CASES)
def test_lsap_plain_matches_lsap_jax(case):
    import jax
    from scipy.optimize import linear_sum_assignment
    from ziragroundingdino_tpu.train.matcher import lsap_jax

    cost = _costs(case)
    got = plsap.lsap_plain(torch.from_numpy(cost)).numpy()
    want = np.asarray(jax.vmap(lsap_jax)(cost))
    np.testing.assert_array_equal(got, want)
    n = cost.shape[2]
    for c, a in zip(cost, got):
        assert len(set(a.tolist())) == n
        rows, cols = linear_sum_assignment(c)
        total = c[a, np.arange(n)].astype(np.float64).sum()
        np.testing.assert_allclose(total, c[rows, cols].astype(np.float64).sum(), rtol=1e-6)


def test_lsap_dispatch_and_refusals():
    cost = torch.from_numpy(_costs("uniform"))
    before = plsap.lsap_cuda.launches
    np.testing.assert_array_equal(plsap.lsap(cost).numpy(), plsap.lsap_plain(cost).numpy())
    with pytest.raises(ValueError, match="not a CUDA device"):
        plsap.lsap_cuda(cost)
    with pytest.raises(ValueError, match="targets exceed"):
        plsap.lsap(cost.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        plsap.lsap(cost.double())
    with pytest.raises(ValueError, match="exceed the kernel's"):
        plsap.lsap(torch.zeros(1, plsap.MAX_Q + 1, 2))
    bad = cost.clone()
    bad[0, 3, 1] = float("nan")
    with pytest.raises(ValueError, match="finite"):
        plsap.lsap(bad)
    assert plsap.lsap_cuda.launches == before
    with pytest.raises(ValueError, match="unknown matcher impl"):
        pmatch.assign(cost, impl="jax")


def test_launch_plan_covers_every_q():
    """Every Q up to MAX_Q gets an instance whose threads own all columns,
    within a block's shared memory, with the row slots that are left."""
    assert plsap.launch_plan(900, 100) == plsap.LaunchPlan(4, 256, 18800 + 58 * 3604, 58)
    assert plsap.launch_plan(900, 5).slots == 5
    for q in range(1, plsap.MAX_Q + 1):
        for n in {1, (q + 1) // 2, q}:
            plan = plsap.launch_plan(q, n)
            assert plan.cols_per_thread in plsap.COLS_PER_THREAD
            assert plan.cols_per_thread * plan.threads >= q
            assert plan.cols_per_thread == 1 or (plan.cols_per_thread // 2) * plan.threads < q
            fixed = -(-(20 * q + 8 * n) // 16) * 16
            assert plan.smem_bytes == fixed + plan.slots * 4 * (q | 1)
            assert plan.smem_bytes <= plsap.SMEM_LIMIT - plsap.SMEM_RESERVE
            assert 0 <= plan.slots <= n
            assert plan.slots == n or plan.smem_bytes + 4 * (q | 1) > (plsap.SMEM_LIMIT
                                                                        - plsap.SMEM_RESERVE)
    with pytest.raises(ValueError, match="targets exceed"):
        plsap.launch_plan(5, 6)
    with pytest.raises(ValueError, match="exceed the kernel's"):
        plsap.launch_plan(plsap.MAX_Q + 1, 2)


def test_set_criterion_default_matcher_matches_jax(tiny_pair):
    """The tiny model's train-mode outputs (last layer, aux layer, encoder
    head) through both criteria with their default matchers; the port
    matches all three in one call."""
    import jax
    import jax.numpy as jnp
    from tests.test_train_step import make_batch
    from ziragroundingdino_tpu.train import criterion as jcrit
    from ziragroundingdino_tpu.train import matcher as jmatcher
    from ziragroundingdino_torch.train.step import class_logits_from_tokens

    batch = make_batch()
    tp = tiny_pair
    with torch.no_grad():
        out = tp.port(torch.from_numpy(np.asarray(batch["pixels"])),
                      torch.from_numpy(np.asarray(batch["mask"])),
                      {k: torch.from_numpy(np.asarray(batch[k]))
                       for k in ("input_ids", "text_token_mask", "position_ids",
                                 "text_self_attention_masks")}, train=True)
    c2t = torch.from_numpy(np.asarray(batch["cate_to_token_mask"]))
    heads = [out] + out["aux_outputs"] + [out["interm_outputs"]]
    heads = [{"pred_logits": class_logits_from_tokens(h["pred_logits"], c2t).numpy(),
              "pred_boxes": h["pred_boxes"].numpy()} for h in heads]

    def nest(to):
        last, *aux, enc = [{k: to(v) for k, v in h.items()} for h in heads]
        return dict(last, aux_outputs=aux, interm_outputs=enc)

    targets = [np.asarray(batch[k]) for k in ("gt_labels", "gt_boxes", "gt_valid")]
    matched = {"jax": [], "port": []}
    jmatch, pmatch_batch = jcrit.match_batch, pcrit.match_batch

    def record(fn, name):
        def match(*args, **kwargs):
            matched[name].append(np.asarray(fn(*args, **kwargs)))
            return matched[name][-1] if name == "jax" else torch.from_numpy(matched[name][-1])
        return match

    def jax_match(*args, impl="jax"):
        # `match_batch`'s body with the costs computed eagerly: under jit,
        # XLA's fused focal cost of this encoder head is not finite in
        # places, and `lsap_jax` then returns a degenerate assignment
        with jax.disable_jit():
            cost = jax.vmap(jmatcher.pairwise_cost_matrix)(*args)
        return jmatcher.match_cost(cost, impl)

    try:
        jcrit.match_batch = record(jax_match, "jax")
        want = jcrit.set_criterion(nest(jnp.asarray), *targets)
        pcrit.match_batch = record(pmatch_batch, "port")
        got = pcrit.set_criterion(nest(torch.from_numpy), *map(torch.from_numpy, targets))
    finally:
        jcrit.match_batch, pcrit.match_batch = jmatch, pmatch_batch
    assert len(matched["jax"]) == len(heads) and len(matched["port"]) == 1
    np.testing.assert_array_equal(matched["port"][0], np.concatenate(matched["jax"]))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=LOSS_TOL, atol=LOSS_TOL,
                                   err_msg=k)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, case):
    cost = torch.from_numpy(_costs(case))
    want = plsap.lsap_plain(cost)
    before = plsap.lsap_cuda.launches
    got = plsap.lsap_cuda(cost.to(cuda_device))
    torch.cuda.synchronize()
    assert plsap.lsap_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_kernel_gives_identity_where_not_finite_on_card(cuda_device):
    """A problem whose only non-finite value sits in an otherwise constant
    (BIG) row, and one with a constant row of +inf, get n -> n; the others
    are solved."""
    cost = _costs("padded")
    cost[1, 4, 6] = np.inf
    cost[2, :, 5] = np.inf
    finite = [0, 3, 4, 5]
    want = plsap.lsap_plain(torch.from_numpy(cost[finite])).numpy()
    before = plsap.lsap_cuda.launches
    got = plsap.lsap_cuda(torch.from_numpy(cost).to(cuda_device)).cpu().numpy()
    assert plsap.lsap_cuda.launches == before + 1
    np.testing.assert_array_equal(got[[1, 2]], np.tile(np.arange(cost.shape[2]), (2, 1)))
    np.testing.assert_array_equal(got[finite], want)
