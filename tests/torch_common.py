"""Shared helpers of the PyTorch port's parity tests.

The JAX package is the reference: both packages get the same tiny config
(`tests/common.py::tiny_config`), the same seeded numpy parameters in the
JAX layout (shapes from `jax.eval_shape` of the JAX model's init, so no JAX
init is compiled), and the same numpy inputs. The port receives the
parameters through its weight bridge (`ziragroundingdino_torch.weights`).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.common import tiny_config, tiny_image_batch, tiny_text_batch
from ziragroundingdino_torch import config as pc
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.weights import jax_params_to_state_dict

# Under pytest-xdist each worker is a process of its own, and torch's
# intra-op pool at its default (a thread per core) in each of them
# oversubscribes the cores: its parallel kernels then wait for their turn
# (six port test files at six workers took 368 s, against 89 s with a thread
# each). A worker takes its share of the cores; a run in one process keeps
# them all. Set while the workers import the test modules, before any test.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def _copy_fields(cls, src, **extra):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: getattr(src, k) for k in names if hasattr(src, k)}
    kw.update(extra)
    return cls(**kw)


def port_config(jcfg) -> pc.GroundingDINOConfig:
    """The port's config with the JAX config's values."""
    return _copy_fields(
        pc.GroundingDINOConfig, jcfg,
        swin_config=_copy_fields(pc.SwinConfig, jcfg.swin),
        bert_config=_copy_fields(pc.BertConfig, jcfg.bert),
    )


def random_params(shape_tree, seed: int = 0):
    """Seeded numpy parameters for a flax shape tree, scaled so that a
    forward stays in a sane range: kernels ~ N(0, 1/fan_in), norm scales
    ~ 1 + N(0, 0.1), frozen-BN variances (ResNet's `var`) ~ U(0.5, 1.5),
    every other leaf ~ N(0, 0.1). Zero-initialized parts
    (box-head last layers, ZiRa freeze branches) become non-zero, so the
    comparison exercises them."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.randn(*s.shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif name == "var":
            z = 0.5 + (z - z.min()) / max(np.ptp(z), 1e-6)
        elif len(s.shape) >= 2:
            z = z / np.sqrt(np.prod(s.shape[:-1]))
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shape_tree)


def random_stats(shape_tree, seed: int = 0):
    """Seeded BatchNorm statistics for a flax `batch_stats` shape tree: means
    ~ N(0, 0.1), variances ~ U(0.5, 1.5)."""
    rng = np.random.RandomState(seed + 1000)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shape_tree)


def jax_inputs(b: int = 2):
    pixels, mask = tiny_image_batch(b=b)
    captions = ("cat.dog.", "zebra.person.fish.")[:b]
    tb = tiny_text_batch(captions=captions)
    text = {k: jnp.asarray(v) for k, v in tb.asdict().items()}
    return pixels, mask, tb, text


def torch_text(tb):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tb.asdict().items()}


def architecture(cfg) -> str:
    """`cfg` with the switches that only pick the trainable parameters reset,
    as a key: the JAX model reads none of them, so its parameters and every
    function of them are the same."""
    return repr(dataclasses.replace(cfg, freeze_all=True, use_bert_tuning=False,
                                    use_prompt_tuning=False, use_project_tuning=False))


# `jax.eval_shape` of the JAX model's init by architecture: tracing the whole
# init takes seconds, and many pairs share one (other seeds, other tests)
_SHAPES = {}


def init_shapes(jmodel, pixels, mask, text):
    """The shape tree of `jmodel.init` on these inputs, traced once per
    architecture and input shapes in a process."""
    key = (architecture(jmodel.cfg), pixels.shape, mask.shape,
           tuple(sorted((k, np.shape(v)) for k, v in text.items())))
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(pixels),
                                      jnp.asarray(mask), text)
    return _SHAPES[key]


class TinyPair:
    """The tiny JAX model and the port built with the same parameters (and,
    for the repconvbn variant, the same BatchNorm statistics: `stats`, the
    JAX `batch_stats` collection, reaches the port's buffers)."""

    def __init__(self, seed: int = 0, **overrides):
        from ziragroundingdino_tpu.models.groundingdino import GroundingDINO

        self.cfg = tiny_config(**overrides)
        self.jmodel = GroundingDINO(cfg=self.cfg)
        self.pixels, self.mask, self.tb, self.text = jax_inputs()
        shapes = init_shapes(self.jmodel, self.pixels, self.mask, self.text)
        self.params = random_params(shapes["params"], seed)
        self.stats = random_stats(shapes["batch_stats"], seed) if "batch_stats" in shapes else {}
        self.port = build_model(port_config(self.cfg), device="cpu", dtype="float32")
        self.port.load_state_dict(jax_params_to_state_dict(self.params, self.stats), strict=True)

    def variables(self, params=None):
        """The JAX model's variables: `params` (default: the pair's) and
        the batch statistics where the model has them."""
        out = {"params": self.params if params is None else params}
        if self.stats:
            out["batch_stats"] = self.stats
        return out


@pytest.fixture(scope="module")
def tiny_pair():
    return TinyPair()


def pinned_matcher(order):
    """A stand-in for the port's `train.criterion.match_batch` that replays
    the assignments of the iterator `order` ([B, N] each, in
    `set_criterion`'s order). The criterion matches its outputs in one call
    on them stacked along the batch, so a call takes as many as it holds."""

    def match(pred_logits, *args, **kwargs):
        parts = []
        while sum(len(p) for p in parts) < pred_logits.shape[0]:
            parts.append(np.asarray(next(order)))
        return torch.from_numpy(np.concatenate(parts)).long()

    return match


def assert_close(got, want, atol, rtol=0.0, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=what)
