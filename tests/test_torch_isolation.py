"""The PyTorch port stands alone: nothing in incubator_mxnet_tpu_torch/ or
chip_smoke.py imports JAX or the JAX package, and its entry points run on
the card unless the caller asks for the CPU (with no CUDA they raise)."""

import ast
import os
import pathlib

import pytest
import torch

import incubator_mxnet_tpu_torch as port
from incubator_mxnet_tpu_torch.ops.kernels import _build

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "incubator_mxnet_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "incubator_mxnet_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("incubator_mxnet_tpu") \
        and _forbidden("incubator_mxnet_tpu.serving")
    assert not _forbidden("incubator_mxnet_tpu_torch")
    assert not _forbidden("incubator_mxnet_tpu_torch.serving")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, "%s imports %s" % (path.relative_to(REPO), bad)


def test_kernel_sources_ship_with_the_package():
    names = sorted(p.name for p in _build.sources())
    assert names == ["flash_attention_bwd.cu", "flash_attention_fwd.cu",
                     "flash_decode.cu", "fused_bottleneck.cu",
                     "fused_norm.cu", "fused_optim.cu", "int8_matmul.cu",
                     "runtime.cu"]
    assert _build.BUILD_DIR == REPO / "build" / "torch_kernels"


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this card has CUDA; the check is for hosts without it")
    from incubator_mxnet_tpu_torch.generate import (
        GPTPagedLM, PagedKVCache, export_gpt_for_serving)
    from incubator_mxnet_tpu_torch.models.bert import (BERTForPretrain,
                                                       BERTModel)
    from incubator_mxnet_tpu_torch.models.gpt import GPTDecoder
    from incubator_mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh
    from incubator_mxnet_tpu_torch.serving import (Int8Dense, KVCache,
                                                   ModelServer,
                                                   load_served_model)
    gpt_cfg = dict(vocab_size=10, units=8, num_layers=1, num_heads=2,
                   max_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        BERTModel(num_layers=1, units=8, hidden_size=8, num_heads=2,
                  vocab_size=10, max_length=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        load_served_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        BERTModel(num_layers=1, units=8, hidden_size=8, num_heads=2,
                  vocab_size=10, max_length=8, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTDecoder(**gpt_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(1, {"k0": ("kv", (2, 4))})
    with pytest.raises(RuntimeError, match="CUDA"):
        KVCache(1, {"k0": ("kv", (2, 4))})
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh({"dp": 1})
    with pytest.raises(RuntimeError, match="CUDA"):
        Int8Dense([[1.0, -2.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        BERTForPretrain(vocab_size=10)
    tiny = dict(num_layers=1, units=8, hidden_size=8, num_heads=2,
                vocab_size=10, max_length=8)
    cpu_bert = BERTModel(device="cpu", **tiny)
    with pytest.raises(RuntimeError, match="CUDA"):
        BERTForPretrain(bert=cpu_bert, vocab_size=10)
    pre = BERTForPretrain(bert=cpu_bert, vocab_size=10, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedTrainer(pre, lambda out, y: out[1].sum(), optimizer="adamw")
    assert make_mesh({"dp": 1}, devices=["cpu"]).device.type == "cpu"
    tr = ShardedTrainer(pre, lambda out, y: out[1].sum(), optimizer="adamw",
                        device="cpu")
    assert all(p.device.type == "cpu" for p in tr.param_values.values())
    # asked for explicitly, the CPU works
    m = BERTModel(num_layers=1, units=8, hidden_size=8, num_heads=2,
                  vocab_size=10, max_length=8, device="cpu")
    assert m.device.type == "cpu"
    srv = ModelServer(device="cpu")
    srv.stop()
    gpt = GPTDecoder(device="cpu", **gpt_cfg)
    params = dict(gpt.named_parameters())
    with pytest.raises(RuntimeError, match="CUDA"):
        GPTPagedLM(params, gpt_cfg)
    assert GPTPagedLM(params, gpt_cfg, device="cpu").make_cache(1) \
        .pool("k0").device.type == "cpu"
    ckpt = str(tmp_path / "gpt")
    export_gpt_for_serving(ckpt, gpt_cfg, gpt)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_served_model(ckpt)
    assert load_served_model(ckpt, device="cpu").family == "gpt_decoder"


@pytest.fixture
def gluon_names_unchanged():
    """Gluon names blocks from per-alias counters global to the process
    (``_BlockScope``); a test that builds the port's nets and no JAX ones
    restores them, so that a later test in the same process that compares
    the two packages' names sees both counters where it would."""
    from incubator_mxnet_tpu_torch.gluon.block import _BlockScope
    saved = dict(_BlockScope._counters)
    yield
    _BlockScope._counters.clear()
    _BlockScope._counters.update(saved)


def test_resnet_entry_points_raise_without_cuda_unless_asked_for_the_cpu(
        gluon_names_unchanged):
    if torch.cuda.is_available():
        pytest.skip("this card has CUDA; the check is for hosts without it")
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    from incubator_mxnet_tpu_torch.ops.kernels import (
        fused_bottleneck, multi_trainer_sgd_mom)
    # gluon nets are placed by initialize(ctx); ctx=None is cuda:0
    for build in (vision.resnet50_v1, vision.resnet18_v2,
                  lambda: vision.get_model("resnet34_v1"),
                  lambda: nn.Conv2D(4, 3, in_channels=3),
                  lambda: nn.Dense(4, in_units=3),
                  lambda: nn.BatchNorm(in_channels=3)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build().initialize()
    net = vision.resnet18_v1(device="cpu", classes=7)
    assert {p.device.type for p in net.parameters()} == {"cpu"}
    with pytest.raises(RuntimeError, match="CUDA"):
        vision.resnet18_v1(device="cuda")
    # the kernels' wrappers run where their tensors lie: plain on the CPU
    w, g, m = torch.ones(3), torch.ones(3), torch.zeros(3)
    multi_trainer_sgd_mom([w], [g], [m], lr=0.5, wd=0.0, momentum=0.9)
    assert torch.equal(w, torch.full((3,), 0.5))
    x = torch.zeros(1, 2, 2, 4)
    out = fused_bottleneck(x, torch.zeros(4, 2), torch.ones(2),
                           torch.zeros(2), torch.zeros(9, 2, 2),
                           torch.ones(2), torch.zeros(2), torch.zeros(2, 4),
                           torch.ones(4), torch.zeros(4))
    assert out.device.type == "cpu" and out.shape == x.shape


def test_contexts():
    assert port.cpu() == torch.device("cpu")
    assert port.gpu(1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="no TPU"):
        port.tpu()
    from incubator_mxnet_tpu_torch.context import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_build_without_nvcc_raises_with_a_reason(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build._nvcc()
