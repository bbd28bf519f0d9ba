"""The port's weight bridge, its construction rules and its independence from
the JAX package.

* JAX params -> `jax_params_to_state_dict` -> the JAX package's own
  `torch_convert.convert_state_dict` gives back the identical tree, with no
  unmatched key; the state dict loads into the port with `strict=True`.
* `load_model` reads a reference-format checkpoint (`module.` prefix,
  `{"model": ...}` wrapper, buffers the port recomputes).
* The port imports neither JAX nor the JAX package; `build_model()` with no
  device raises where there is no card; a seed fixes the weights.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.torch_common import port_config, tiny_pair  # noqa: F401  (fixture)
from ziragroundingdino_tpu.utils import torch_convert as tc
from ziragroundingdino_torch.models import build_model
from ziragroundingdino_torch.text.tokenizer import make_synthetic_vocab
from ziragroundingdino_torch.utils.inference import load_model
from ziragroundingdino_torch.weights import jax_params_to_state_dict

REPO = pathlib.Path(__file__).resolve().parents[1]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def test_round_trip_through_jax_converter(tiny_pair):
    sd = jax_params_to_state_dict(tiny_pair.params)
    tree, batch_stats, prompt_memory, unmatched = tc.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert unmatched == [] and batch_stats == {} and prompt_memory == {}
    want, got = _flatten(tiny_pair.params), _flatten(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_keys_and_strict_load(tiny_pair):
    """Reference key names, the shared box head under every decoder layer,
    and a strict load that sets every tensor of the port."""
    sd = jax_params_to_state_dict(tiny_pair.params)
    for key in ("backbone.0.layers.1.blocks.0.attn.qkv.weight",
                "bert.encoder.layer.0.attention.self.query.weight",
                "input_proj.3.0.weight", "input_proj_conv_adapter.0.freeze_conv.weight",
                "rep_linear_adapter.freeze_linear.weight",
                "transformer.decoder.layers.1.ca_text.in_proj_weight",
                "bbox_embed.1.layers.2.weight",
                "transformer.decoder.bbox_embed.0.layers.0.bias"):
        assert key in sd, key
    assert sd["input_proj.3.0.weight"].shape == (64, 64, 3, 3)
    assert sd["bbox_embed.1.layers.2.weight"] is sd["bbox_embed.0.layers.2.weight"]
    model = build_model(port_config(tiny_pair.cfg), device="cpu", dtype="float32", seed=3)
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_load_model_reads_reference_checkpoint(tiny_pair, tmp_path):
    sd = jax_params_to_state_dict(tiny_pair.params)
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    ckpt["module.bert.embeddings.position_ids"] = torch.arange(8)[None]
    ckpt["module.backbone.0.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(4, 4)
    ckpt["module.bert.pooler.dense.weight"] = torch.zeros(4, 4)
    torch.save({"model": ckpt}, tmp_path / "ckpt.pth")
    vocab = make_synthetic_vocab(["cat", "dog"])
    (tmp_path / "vocab.txt").write_text(
        "".join(w + "\n" for w, _ in sorted(vocab.items(), key=lambda kv: kv[1])))
    pcfg = port_config(tiny_pair.cfg)
    overrides = {f: getattr(pcfg, f) for f in (
        "hidden_dim", "nheads", "dim_feedforward", "enc_layers", "dec_layers", "num_queries",
        "max_text_len", "max_categories", "swin_config", "bert_config")}
    lm = load_model(str(tmp_path / "ckpt.pth"), str(tmp_path / "vocab.txt"), device="cpu",
                    dtype="float32", **overrides)
    assert lm.tokenizer.vocab == vocab and lm.device == torch.device("cpu")
    for k, v in lm.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)


def test_port_imports_no_jax():
    """In a process where `import jax` fails, every module of the port
    imports and no module of the JAX package is loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import ziragroundingdino_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.startswith('ziragroundingdino_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'ziragroundingdino_torch.models.transformer' in names\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_sources_name_no_jax():
    pattern = re.compile(r"import jax|from jax|flax|ziragroundingdino_tpu")
    files = sorted((REPO / "ziragroundingdino_torch").rglob("*.py"))
    files += sorted((REPO / "ziragroundingdino_torch").rglob("*.cu")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{f.name}:{i}: {line}"


def test_build_model_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model()


def test_seeded_init_is_deterministic_and_complete(tiny_pair):
    cfg = port_config(tiny_pair.cfg)
    a = build_model(cfg, device="cpu", seed=1).state_dict()
    b = build_model(cfg, device="cpu", seed=1).state_dict()
    c = build_model(cfg, device="cpu", seed=2).state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.isfinite(a[k]).all(), k
    assert not torch.equal(a["transformer.level_embed"], c["transformer.level_embed"])
    assert build_model(cfg, device="cpu", dtype=torch.bfloat16).cfg.compute_dtype == "bfloat16"
