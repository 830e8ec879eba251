"""The port stands alone: no module of nanosnp_tpu_torch imports jax or
the JAX package, importing it builds nothing, and an entry point asked
for the card on a machine without one raises instead of running on the
CPU."""
import ast
import importlib
import pathlib
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parent.parent / "nanosnp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "nanosnp_tpu")


def _modules():
    return sorted(PKG.rglob("*.py"))


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    # compare whole dotted components: "nanosnp_tpu_torch" is allowed
    return name.split(".")[0] in FORBIDDEN


def test_forbidden_prefix_check_is_exact():
    assert _forbidden("nanosnp_tpu") and _forbidden("nanosnp_tpu.io.bins")
    assert _forbidden("jax.numpy")
    assert not _forbidden("nanosnp_tpu_torch.io.bins")


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(
    p.relative_to(PKG)))
def test_module_imports_no_jax_or_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported_names(tree) if _forbidden(n)]
    assert not bad, f"{path}: imports {bad}"


def test_importing_every_module_builds_nothing(monkeypatch):
    from nanosnp_tpu_torch.ops import build

    def no_build(*a, **k):
        raise AssertionError("a kernel build started at import time")

    from nanosnp_tpu_torch.io import native

    monkeypatch.setattr(build, "build_all", no_build)
    monkeypatch.setattr(native, "_build", no_build)
    for path in _modules():
        rel = path.relative_to(PKG.parent).with_suffix("")
        importlib.import_module(".".join(rel.parts).replace(".__init__", ""))


def test_host_stage_modules_are_under_the_scan():
    names = {str(p.relative_to(PKG)) for p in _modules()}
    assert {"io/native.py", "io/bam.py", "io/verify.py", "features/pileup.py",
            "features/haplotype.py", "decode/sort.py",
            "phase/native_phaser.py", "runtime/pipeline.py",
            "runtime/extract.py", "runtime/external.py", "runtime/stages.py",
            "runtime/cli.py", "utils/profiling.py", "ops/probe.py"} <= names


# what chip_smoke.py may import besides the standard library: torch,
# numpy, the port, and the numpy-only world generators of tests/
SMOKE_ALLOWED = {"torch", "numpy", "nanosnp_tpu_torch", "synth", "bamgen",
                 "diploid"}


def test_chip_smoke_imports_only_torch_numpy_the_port_and_generators():
    path = PKG.parent / "chip_smoke.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = {n.split(".")[0] for n in _imported_names(tree)}
    assert "nanosnp_tpu_torch" in tops
    bad = sorted(t for t in tops
                 if t not in SMOKE_ALLOWED
                 and t not in sys.stdlib_module_names)
    assert not bad, f"chip_smoke.py imports {bad}"
    for gen in ("synth", "bamgen", "diploid"):
        gtree = ast.parse((PKG.parent / "tests" / f"{gen}.py").read_text())
        gtops = {n.split(".")[0] for n in _imported_names(gtree)}
        assert gtops <= {"numpy", "bamgen"} | sys.stdlib_module_names, gen


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from nanosnp_tpu_torch.config import PipelineConfig
    from nanosnp_tpu_torch.runtime import stages

    cfg = PipelineConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stages.stage_pileup_predict(cfg, None, str(tmp_path),
                                    str(tmp_path / "out.vcf"), params={})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stages.stage_haplotype_predict(cfg, None, str(tmp_path),
                                       str(tmp_path / "out.csv"), params={})
    assert not (tmp_path / "out.vcf").exists()


def test_trainers_ask_for_the_card_and_raise_before_writing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from nanosnp_tpu_torch.config import (HaplotypeModelConfig,
                                          PileupModelConfig, TrainConfig)
    from nanosnp_tpu_torch.runtime import cli
    from nanosnp_tpu_torch.train.train_haplotype import train_haplotype
    from nanosnp_tpu_torch.train.train_pileup import train_pileup

    for fn, cfg in ((train_pileup, PileupModelConfig()),
                    (train_haplotype, HaplotypeModelConfig())):
        out = tmp_path / fn.__name__
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(iter([]), cfg, TrainConfig(), None, str(out))
        assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train-pileup", "--data", str(tmp_path), "-o",
                  str(tmp_path / "cli")])
    assert not (tmp_path / "cli").exists()


def test_legacy_package_is_under_the_scan():
    names = {str(p.relative_to(PKG)) for p in _modules()}
    assert {"legacy/catmodel.py", "legacy/train.py", "legacy/bins.py",
            "legacy/edges.py", "legacy/heuristic.py", "legacy/labelcheck.py",
            "legacy/config_archive.py", "ops/bilstm_fused.py"} <= names


@pytest.mark.parametrize("cmd", ["legacy-predict", "legacy-eval",
                                 "legacy-train"])
def test_legacy_clis_ask_for_the_card_and_raise_before_writing(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from nanosnp_tpu_torch.runtime import cli

    args = ["--data-tag1", str(tmp_path), "--data-tag2", str(tmp_path)]
    if cmd != "legacy-predict":
        args += ["--ref", "r.fa", "--truth-vcf", "t.vcf", "--bed", "c.bed"]
    if cmd != "legacy-train":
        args += ["--model", "cat.npz"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([cmd, *args, "-o", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_legacy_trainer_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from nanosnp_tpu_torch.legacy.train import CatModelTrainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CatModelTrainer({}, out_dir=str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
