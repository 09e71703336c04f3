"""The port's boundaries: no JAX inside it, the card by default, and no
quiet fallback from a kernel to its plain version."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.ann import AnnEngine, CodeStore
from repro_torch.core.schemes import CodeSpec
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
from repro_torch.index import MutableAnnEngine, SegmentLogStore, restore_index
from repro_torch.kernels import ops
from repro_torch.learn import (PackedFeatureSpec, PackedLinearModel,
                               expand_codes, train_dense_linear)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: CodedRandomProjection(SketchConfig(k=32), 8),
    lambda: CodedRandomProjection(SketchConfig(k=32), 8, device="cuda"),
    lambda: CodeStore.from_words(np.zeros((2, 2), np.int32), 32, 2),
    lambda: convert.store_from_numpy(np.zeros((2, 2), np.uint32), 32, 2),
    lambda: convert.sketch_from_numpy(SketchConfig(k=32), 8,
                                      np.zeros((8, 32), np.float32)),
    lambda: SegmentLogStore(32, 2),
    lambda: restore_index("no-such-snapshot"),
    lambda: restore_checkpoint("no-such-checkpoint", 0, {}),
    lambda: PackedLinearModel.zeros(PackedFeatureSpec(32, 2, 4)),
    lambda: convert.linear_model_from_numpy(
        PackedFeatureSpec(32, 2, 4), np.zeros((1, 128), np.float32),
        np.zeros(1, np.float32)),
    lambda: train_dense_linear(np.zeros((4, 3), np.float32),
                               np.ones(4, np.float32)),
    lambda: expand_codes(np.zeros((2, 32), np.int32), CodeSpec("2bit", 0.75)),
    lambda: PackedFeatureSpec(32, 2, 4).entry_mask(),
    lambda: PackedFeatureSpec(32, 2, 4).tables_from_dense(
        np.zeros((1, 128), np.float32)),
    lambda: PackedFeatureSpec(32, 2, 4).dense_from_tables(
        np.zeros((1, 128), np.float32)),
], ids=["sketch-default", "sketch-cuda", "store", "store-numpy",
        "sketch-numpy", "segment-log", "restore-index", "restore-checkpoint",
        "linear-model", "linear-model-numpy", "dense-linear", "expand-codes",
        "entry-mask", "tables-from-dense", "dense-from-tables"])
def test_entry_points_need_the_card_unless_asked(no_cuda, make):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_cpu_on_request(no_cuda):
    crp = CodedRandomProjection(SketchConfig(k=64), 8, device="cpu")
    eng = AnnEngine.build(crp, np.ones((4, 8), np.float32))
    assert eng.store.words.device.type == "cpu"


def test_mutable_index_on_cpu_on_request(no_cuda, tmp_path):
    crp = CodedRandomProjection(SketchConfig(k=64), 8, device="cpu")
    eng = MutableAnnEngine(crp, tail_rows=32)
    eng.ingest(np.ones((40, 8), np.float32))
    assert eng.store.tail.words.device.type == "cpu" and eng.n == 40
    eng.save(str(tmp_path), 1)
    assert MutableAnnEngine.restore(crp, str(tmp_path)).n == 40
    with pytest.raises(NotImplementedError, match="item 10"):
        eng.attach_quality(None)


@pytest.mark.parametrize("call", [
    lambda x, r, c, w: ops.coded_project(x, r, CodeSpec("2bit", 0.75),
                                         impl="kernel"),
    lambda x, r, c, w: ops.encode_fused(x, r, CodeSpec("2bit", 0.75),
                                        impl="kernel"),
    lambda x, r, c, w: ops.pack_codes(c, 2, impl="kernel"),
    lambda x, r, c, w: ops.packed_topk(w, w, 2, 32, 3, impl="kernel"),
    lambda x, r, c, w: ops.packed_collision_counts(w, w, 2, 32,
                                                   impl="kernel"),
    lambda x, r, c, w: ops.packed_lut_rerank(
        torch.zeros(4, 128), w[:, None, :], torch.ones(4, 1, dtype=torch.bool),
        2, 3, impl="kernel"),
    lambda x, r, c, w: ops.fused_scored_topk(w, torch.zeros(4, 128), w, 2, 32,
                                             4, 3, impl="kernel"),
    lambda x, r, c, w: ops.packed_topk_masked(
        w, w, torch.ones(1, dtype=torch.int32), 2, 32, 3, impl="kernel"),
    lambda x, r, c, w: ops.fused_scored_topk_masked(
        w, torch.zeros(4, 128), w, torch.ones(1, dtype=torch.int32), 2, 32, 4,
        3, impl="kernel"),
    lambda x, r, c, w: ops.code_pack(x, CodeSpec("2bit", 0.75),
                                     impl="kernel"),
    lambda x, r, c, w: ops.normal_unit((0, 1), 8, 32, "cpu", impl="kernel"),
    lambda x, r, c, w: ops.normal_from_bits(c, impl="kernel"),
    lambda x, r, c, w: ops.csr_unit_step(
        torch.zeros(4, 32), torch.zeros(5, dtype=torch.int64),
        torch.zeros(0, dtype=torch.int32), torch.zeros(0), r, 0,
        impl="kernel"),
    lambda x, r, c, w: ops.packed_linear_fwd(torch.zeros(1, 128), w, 2,
                                             impl="kernel"),
    lambda x, r, c, w: ops.packed_linear_fwd_masked(
        torch.zeros(1, 128), w, torch.ones(1, dtype=torch.int32), 2,
        impl="kernel"),
    lambda x, r, c, w: ops.packed_linear_bwd(torch.zeros(1, 4), w, 2,
                                             impl="kernel"),
    lambda x, r, c, w: ops.packed_linear_bwd_masked(
        torch.zeros(1, 4), w, torch.ones(1, dtype=torch.int32), 2,
        impl="kernel"),
], ids=["coded_project", "encode_fused", "pack_codes", "packed_topk",
        "packed_collision_counts", "packed_lut_rerank", "fused_scored_topk",
        "packed_topk_masked", "fused_scored_topk_masked", "code_pack",
        "normal_unit", "normal_from_bits", "csr_unit_step",
        "packed_linear_fwd", "packed_linear_fwd_masked", "packed_linear_bwd",
        "packed_linear_bwd_masked"])
def test_kernel_impl_on_cpu_raises(call):
    x, r = torch.zeros(4, 8), torch.zeros(8, 32)
    codes, words = torch.zeros(4, 32, dtype=torch.int32), torch.zeros(
        4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        call(x, r, codes, words)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        ops.pack_codes(torch.zeros(2, 4, dtype=torch.int32), 2, impl="pallas")


def test_import_builds_nothing():
    """Importing every module of the port compiles and loads nothing."""
    mods = sorted(os.path.relpath(f, os.path.join(ROOT, "src"))[:-3]
                  .replace(os.sep, ".").removesuffix(".__init__")
                  for f in _port_files() if f.startswith(PORT))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import _build\n"
            "sys.exit(1 if _build._libs else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
