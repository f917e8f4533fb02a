"""The port stands alone: importing every module of mpnn_tpu_torch loads
neither jax nor any mpnn_tpu module, no source file of the port (nor
chip_smoke.py) names the JAX package, and the entry points ask for the
card unless the caller asks for the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import mpnn_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mpnn_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        mpnn_tpu_torch.__path__, "mpnn_tpu_torch."))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_imports_leave_jax_and_mpnn_tpu_out():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'mpnn_tpu' or "
            "k.startswith('mpnn_tpu.'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
    assert len(_modules()) >= 25


def test_sources_never_name_the_jax_package():
    pat = re.compile(r"mpnn_tpu\.|^\s*(import|from)\s+jax\b", re.M)
    for path in _sources():
        with open(path) as f:
            text = f.read()
        hits = [m.group(0) for m in pat.finditer(text)]
        assert not hits, f"{os.path.relpath(path, REPO)}: {hits}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mpnn_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("entry", ["network_init", "params_from_jax_arrays",
                                   "load_checkpoint", "evaluate",
                                   "predict_records", "train"])
def test_entry_points_raise_without_card(entry, tmp_path):
    """Each entry point, called without a device on a host with no card,
    raises instead of running on the CPU; with device='cpu' it runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 module_to_jax_arrays,
                                                 params_from_jax_arrays,
                                                 save_checkpoint)
    from mpnn_tpu_torch.train.cli import predict_records
    from mpnn_tpu_torch.train.trainer import TrainConfig, evaluate, train
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(
        ["CCO", "C", "c1ccccc1"], [0.1, 0.2, 0.3]))
    cfg = zoo.lipo(ge.atom_width(), ge.bond_width(),
                   int(gs[0].nafm.shape[-1]))
    net = network_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, net)
    loader = G.GraphLoader(gs, 2, collate="packed")
    calls = {
        "network_init": lambda **kw: network_init(cfg, None, **kw),
        "params_from_jax_arrays": lambda **kw: params_from_jax_arrays(
            module_to_jax_arrays(net), cfg, **kw),
        "load_checkpoint": lambda **kw: load_checkpoint(ckpt, cfg, **kw),
        "evaluate": lambda **kw: evaluate(net, loader, "mse", **kw),
        "predict_records": lambda **kw: list(predict_records(
            experiments.get("lipo"), gs, ckpt, batch_size=2, **kw)),
        "train": lambda **kw: train(cfg, TrainConfig(epochs=1, batch_size=2),
                                    gs, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None


def test_evaluate_refuses_a_module_on_another_device():
    """evaluate neither moves the module nor runs it where the caller did
    not ask: a module off the run's device raises."""
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import zoo
    from mpnn_tpu_torch.models.network import make_module
    from mpnn_tpu_torch.train.trainer import evaluate
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(["CCO", "C"],
                                                     [0.1, 0.2]))
    cfg = zoo.lipo(ge.atom_width(), ge.bond_width(),
                   int(gs[0].nafm.shape[-1]))
    net = make_module(cfg, "meta")
    with pytest.raises(ValueError, match="the module is on meta"):
        evaluate(net, G.GraphLoader(gs, 2, collate="packed"), "mse",
                 device="cpu")


def test_kernel_wrapper_builds_nothing_at_import():
    from mpnn_tpu_torch.kernels import build
    assert build._LIBS == {}
    assert set(build.SOURCES) == {"fused_eval", "fused_step_fwd",
                                  "fused_step_bwd", "fused_psteps_eval",
                                  "fused_psteps_fwd", "fused_psteps_bwd",
                                  "fused_att_fwd", "fused_att_bwd",
                                  "set2vec_fwd", "set2vec_bwd"}
    for src in build.SOURCES.values():
        assert os.path.exists(os.path.join(build.CSRC, src))


@pytest.mark.parametrize("exp", ["graph_norm_classification",
                                 "encoded_classification",
                                 "adv_classification"])
@pytest.mark.parametrize("entry", ["network_init", "evaluate",
                                   "predict_records", "train"])
def test_psteps_entry_points_raise_without_card(entry, exp, tmp_path):
    """The per-step family's and the attention model's entry points,
    called without a device on a host with no card, raise instead of
    running on the CPU; with device='cpu' they run (their plain
    versions)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from mpnn_tpu_torch import graphs as G
    from mpnn_tpu_torch.models import build
    from mpnn_tpu_torch.models.network import network_init
    from mpnn_tpu_torch.train import experiments
    from mpnn_tpu_torch.train.checkpoint import save_checkpoint
    from mpnn_tpu_torch.train.cli import predict_records
    from mpnn_tpu_torch.train.trainer import TrainConfig, evaluate, train
    gs, ge = G.encode_molgraphs(G.generate_molgraphs(
        ["CCO", "C", "c1ccccc1", "CC(=O)O"], [0, 1, 1, 0]))
    e = experiments.get(exp)
    cfg = build(e.model, afm=ge.atom_width(), bfm=ge.bond_width(),
                nafm=int(gs[0].nafm.shape[-1]), n_out=2)
    net = network_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, net)
    loader = G.GraphLoader(gs, 2)
    calls = {
        "network_init": lambda **kw: network_init(cfg, None, **kw),
        "evaluate": lambda **kw: evaluate(net, loader, "ce", **kw),
        "predict_records": lambda **kw: list(predict_records(
            e, gs, ckpt, batch_size=2, **kw)),
        "train": lambda **kw: train(cfg, TrainConfig(
            epochs=1, batch_size=2, loss="ce"), gs, **kw),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert calls[entry](device="cpu") is not None
