"""The port stands alone: it imports no jax, no flax and nothing of the JAX
package; its entry points run on the card unless asked for the CPU; what
the port does not cover yet raises instead of running something else.

Mind the name prefix: ``prostatemr_3d_cad_cspca_tpu_torch`` starts with
``prostatemr_3d_cad_cspca_tpu``, so every check matches the JAX package's
name only when '.', whitespace or the end of the name follows it.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

import prostatemr_3d_cad_cspca_tpu_torch as port
import prostatemr_3d_cad_cspca_tpu_torch.cli  # noqa: F401  (port.cli)
import prostatemr_3d_cad_cspca_tpu_torch.export  # noqa: F401  (port.export)
from prostatemr_3d_cad_cspca_tpu_torch.augment import AugmentParams, make_augment_fn
from prostatemr_3d_cad_cspca_tpu_torch.ensemble import M1Ensemble
from prostatemr_3d_cad_cspca_tpu_torch.load import load_model_spec
from prostatemr_3d_cad_cspca_tpu_torch.models import M1
from prostatemr_3d_cad_cspca_tpu_torch.serve import InferenceSession
from prostatemr_3d_cad_cspca_tpu_torch.train import (CheckpointManager, fit, init_train_state,
                                                     make_optimizer)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(port.__file__)
JAX_PKG = re.compile(r"prostatemr_3d_cad_cspca_tpu(?=[.\s]|$)")
FORBIDDEN = ("jax", "jaxlib", "flax", "prostatemr_3d_cad_cspca_tpu")
TINY = dict(input_spatial_dims=(4, 16, 16), input_channels=3, num_classes=2,
            filters=(4, 8, 12, 16, 24), se_reduction=(2,) * 5, summary=False)


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), os.path.dirname(PKG_DIR))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


@pytest.mark.parametrize("name,expect", [
    ("prostatemr_3d_cad_cspca_tpu", True),
    ("prostatemr_3d_cad_cspca_tpu.models.m1", True),
    ("from prostatemr_3d_cad_cspca_tpu import serve", True),
    ("prostatemr_3d_cad_cspca_tpu_torch", False),
    ("prostatemr_3d_cad_cspca_tpu_torch.models.m1", False),
])
def test_name_check_minds_the_prefix(name, expect):
    assert bool(JAX_PKG.search(name)) == expect


def test_importing_the_port_loads_no_jax():
    mods = _port_modules()
    assert len(mods) >= 20, mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    for mod in ("serve", "infer", "ensemble", "prng", "ops.gemm", "probes.gemm_rate",
                "augment", "data.generators", "data.preprocess", "cli", "train.checkpoint",
                "utils.profiling", "utils.overview", "data.ingest", "export", "utils.flops",
                "utils.tf_import", "parallel.mesh", "parallel.collectives", "parallel.halo",
                "parallel.sharding"):
        assert f"prostatemr_3d_cad_cspca_tpu_torch.{mod}" in loaded


IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    with open(path) as f:
        src = f.read()
    for mod in IMPORT_RE.findall(src):
        assert mod.split(".")[0] not in FORBIDDEN, (path, mod)
    assert not re.search(r"(import|from)\s+" + JAX_PKG.pattern, src), path


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M1(**TINY)
    model = M1(**TINY, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceSession(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.serve.main(["--MODEL", "x.npz", "--MANIFEST", "m.csv",
                         "--OUTPUT_DIR", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_augment_fn(AugmentParams())
    # training: the CLI without --DEVICE cpu, fit of a model that says it is
    # on the card, a checkpoint restored without a model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.cli.main(["--WEIGHTS_DIR", str(tmp_path / "w"), "--NUM_EPOCHS", "1"])
    assert not (tmp_path / "w").exists()
    on_card = M1(**TINY, device="cpu")
    on_card.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(on_card, iter([]))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, init_train_state(model, make_optimizer()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore()
    payload, step = mgr.restore(device="cpu")
    assert step == 1 and payload["step"] == 0 and set(payload["params"]) == set(model.params)
    # export: the CLI without --DEVICE cpu, and loading an artifact
    model.save(str(tmp_path / "m.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.export.main(["--MODEL", str(tmp_path / "m.npz"), "--OUT", str(tmp_path / "a.zip")])
    assert not (tmp_path / "a.zip").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.export.ExportedModel.load(str(tmp_path / "a.zip"))


def test_mc_dropout_at_rate_zero_is_deterministic():
    model = M1(**TINY, dropout_mode="monte-carlo", dropout_rate=0.0, device="cpu")
    x = torch.randn(1, 4, 16, 16, 3)
    assert torch.equal(model.predict(x), model.predict(x))


@pytest.mark.parametrize("spec", ["a.npz,b.npz", "artifact.zip"])
def test_load_spec_refuses_ensembles_and_artifacts(spec, tmp_path, monkeypatch):
    """Fold ensembles load (``M1Ensemble``); an exported artifact loads only
    where the caller serves from one (``allow_artifact=True``, JAX's rule),
    and never inside an ensemble spec."""
    monkeypatch.chdir(tmp_path)
    model = M1(**TINY, device="cpu")
    for name in ("a.npz", "b.npz"):
        model.save(name)
    if spec.endswith(".zip"):
        for bad, allow in ((spec, False), (f"a.npz,{spec}", False), (f"a.npz,{spec}", True)):
            with pytest.raises(ValueError, match="live checkpoint"):
                load_model_spec(bad, allow_artifact=allow, device="cpu")
        return
    ens = load_model_spec(spec, device="cpu")
    assert isinstance(ens, M1Ensemble) and ens.num_members == 2
    assert ens.device == torch.device("cpu")
