"""Rules of the PyTorch/CUDA port (dear_pytorch_tpu_torch):

  - it imports neither jax/flax/optax nor the JAX package — checked in a
    fresh interpreter (this pytest process has jax loaded by
    tests/conftest.py) and by a static scan of every import statement;
  - its entry points run on the CUDA card unless the caller names another
    device, and raise without a card instead of running on the CPU.
"""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.serving.engine import DecodeEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "dear_pytorch_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
_FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax"}


def _module_names():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts[:-1]
                 if p.name == "__init__.py"
                 else p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT.rglob("*.py"))


def _is_jax_package(name: str) -> bool:
    # the port's own name starts with "dear_pytorch_tpu": match the JAX
    # package only as a whole name or a dotted prefix
    return name == "dear_pytorch_tpu" or name.startswith("dear_pytorch_tpu.")


def test_jax_package_matcher_spares_the_port():
    assert _is_jax_package("dear_pytorch_tpu")
    assert _is_jax_package("dear_pytorch_tpu.serving.engine")
    assert not _is_jax_package("dear_pytorch_tpu_torch")
    assert not _is_jax_package("dear_pytorch_tpu_torch.ops.flash_attention")


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    modules = _module_names()
    assert "dear_pytorch_tpu_torch.serving.engine" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded
           if m.split(".")[0] in _FORBIDDEN_ROOTS or _is_jax_package(m)]
    assert not bad, bad
    assert "dear_pytorch_tpu_torch.ops.flash_attention" in loaded
    for ring in ("dear_pytorch_tpu_torch.comm.ring",
                 "dear_pytorch_tpu_torch.ops.collective_matmul",
                 "dear_pytorch_tpu_torch.models.bert",
                 "dear_pytorch_tpu_torch.models.resnet",
                 "dear_pytorch_tpu_torch.benchmarks.imagenet",
                 "dear_pytorch_tpu_torch.models.vit",
                 "dear_pytorch_tpu_torch.benchmarks.bert",
                 "dear_pytorch_tpu_torch.bench",
                 "dear_pytorch_tpu_torch.models.densenet",
                 "dear_pytorch_tpu_torch.models.inception",
                 "dear_pytorch_tpu_torch.models.vgg",
                 "dear_pytorch_tpu_torch.models.mnist",
                 "dear_pytorch_tpu_torch.models.convert",
                 "dear_pytorch_tpu_torch.examples.mnist"):
        assert ring in modules and ring in loaded


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN_ROOTS, (path, name)
            assert not _is_jax_package(name), (path, name)


def _small_config():
    return tgpt.GptConfig(
        vocab_size=61, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, kv_cache_len=16)


def test_entry_points_need_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.GptLmHeadModel(cfg)
    model = tgpt.GptLmHeadModel(cfg, device="cpu")
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.generate(model, [[1, 2]], 2)
    assert tgpt.generate(model, [[1, 2]], 2, device="cpu").shape == (1, 4)
    assert DecodeEngine(model, device="cpu").device == torch.device("cpu")


def test_training_entry_points_need_the_card_unless_told_otherwise(
        monkeypatch):
    """The train step, the process group and the training CLI run on the
    card by default and raise without one; nothing falls back to the CPU
    or to gloo."""
    from dear_pytorch_tpu_torch.benchmarks import gpt as cli
    from dear_pytorch_tpu_torch.comm import backend
    from dear_pytorch_tpu_torch.parallel.dear import build_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backend.init()
    model = tgpt.GptLmHeadModel(_small_config(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(lambda m, b: m(b).sum(), model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--num-hidden-layers", "1", "--sequence-len", "8"])
    with pytest.raises(ValueError, match="model lives on cpu"):
        build_train_step(lambda m, b: m(b).sum(), model, device="meta")


def test_entry_points_refuse_a_device_the_model_is_not_on():
    model = tgpt.GptLmHeadModel(_small_config(), device="cpu")
    with pytest.raises(ValueError, match="model lives on cpu"):
        DecodeEngine(model, device="meta")
    with pytest.raises(ValueError, match="model lives on cpu"):
        tgpt.generate(model, [[1, 2]], 2, device="meta")
    assert dataclasses.replace(model.config, dtype=torch.bfloat16).dtype \
        == torch.bfloat16


def test_resnet_entry_points_need_the_card_unless_told_otherwise(
        monkeypatch):
    """The ResNet slice's entry points — the model, the image batch and the
    ImageNet CLI — run on the card by default and raise without one; with
    ``device="cpu"`` they run the plain PyTorch path."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.benchmarks import imagenet
    from dear_pytorch_tpu_torch.models.data import synthetic_image_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.get_model("resnet50")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_image_batch(0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        imagenet.main(["--model", "resnet18", "--batch-size", "2"])
    assert models.get_model("resnet50", device="cpu").device == \
        torch.device("cpu")
    batch = synthetic_image_batch(0, 2, image_size=32, device="cpu")
    assert batch["image"].device == torch.device("cpu")
    res = imagenet.main(["--device", "cpu", "--model", "resnet18",
                         "--batch-size", "2", "--num-warmup-batches", "0",
                         "--num-batches-per-iter", "1", "--num-iters", "1"])
    assert res.device == "CPU" and res.unit == "img"
    assert len(res.losses) == 1 and res.train_step.update_launches == \
        res.train_step.plan.num_buckets


def test_bert_vit_and_bench_entry_points_need_the_card_unless_told_otherwise(
        monkeypatch, capsys):
    """BERT, ViT, the BERT batch, the BERT CLI and the bench entry run on
    the card by default and raise without one (the bench prints its error
    line and exits 2, as bench.py does for a down backend); with
    ``device="cpu"`` the models run the plain PyTorch path."""
    from dear_pytorch_tpu_torch import bench
    from dear_pytorch_tpu_torch.benchmarks import bert as bert_cli
    from dear_pytorch_tpu_torch.models import bert as tbert
    from dear_pytorch_tpu_torch.models import vit as tvit
    from dear_pytorch_tpu_torch.models.data import synthetic_bert_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(tbert.BERT_BASE, num_hidden_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbert.BertForPreTraining(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvit.ViTS16(num_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_bert_batch(0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bert_cli.main(["--num-hidden-layers", "1", "--sentence-len", "8"])
    assert bench.main([]) == 2
    line = json.loads(capsys.readouterr().out.strip())
    assert line["metric"] == bench.PRIMARY_METRIC
    assert "no CUDA device" in line["error"]
    assert tbert.BertForPreTraining(cfg, device="cpu").device == \
        torch.device("cpu")
    assert tvit.ViTS16(num_layers=1, device="cpu").device == \
        torch.device("cpu")
    assert synthetic_bert_batch(0, 2, device="cpu")["input_ids"].device == \
        torch.device("cpu")


def test_zoo_serving_and_example_entry_points_need_the_card(monkeypatch):
    """The rest of the zoo (DenseNet, Inception-v4, VGG, MnistNet), the
    MNIST batch, the MNIST example and BERT serving through DecodeEngine
    run on the card by default and raise without one; with
    ``device="cpu"`` they run the plain PyTorch path. The HF converters
    and the real digits' loader are host code (no device)."""
    from dear_pytorch_tpu_torch import models
    from dear_pytorch_tpu_torch.examples import mnist as example
    from dear_pytorch_tpu_torch.models import bert as tbert
    from dear_pytorch_tpu_torch.models.data import synthetic_mnist_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("densenet121", "inceptionv4", "vgg11", "mnistnet"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            models.get_model(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_mnist_batch(0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--data", "synthetic", "--epochs", "1"])
    cfg = tbert.BertConfig(vocab_size=61, hidden_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=64, max_position_embeddings=32,
                           kv_cache_len=16)
    bert = tbert.BertForPreTraining(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(bert)
    engine = DecodeEngine(bert, device="cpu")
    assert engine.device == torch.device("cpu")
    assert bert.init_cache(2)[0][0].device == torch.device("cpu")
    assert models.get_model("mnistnet", device="cpu").device == \
        torch.device("cpu")
    assert synthetic_mnist_batch(0, 2, device="cpu")["image"].device == \
        torch.device("cpu")
