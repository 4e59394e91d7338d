"""The port's ingest (``data/ingest.py``) against the JAX package's on
the same raw cases: byte-identical .npy volumes and identical fold
manifests (paths taken relative to each output directory), for cases at
the target spacing, cases resampled through a manifest ``spacing`` column
and ``.npz`` images that carry their own spacing; and the error paths of
tests/test_ingest.py. Host numpy and scipy only.
"""

import csv
import os

import numpy as np
import pytest

from prostatemr_3d_cad_cspca_tpu.data import ingest as jingest
from prostatemr_3d_cad_cspca_tpu_torch.data import ingest
from prostatemr_3d_cad_cspca_tpu_torch.data.manifest import read_manifest


def write_raw(tmp, n=6, shape=(10, 40, 40), spacing=None, npz=False):
    """Raw cases (image (D, H, W, 3), uint8 label and zones) and their
    manifest; with ``spacing``, in a manifest column or inside the npz."""
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        ip = os.path.join(tmp, f"raw{i}_img" + (".npz" if npz else ".npy"))
        lp, zp = os.path.join(tmp, f"raw{i}_lab.npy"), os.path.join(tmp, f"raw{i}_zon.npy")
        img = rng.normal(size=(*shape, 3)).astype(np.float32) * 50 + 200
        lab = np.zeros(shape, np.uint8)
        lab[4:6, 10:22, 10:22] = 2
        lab[5, 25:30, 5:9] = 3
        if npz:
            np.savez(ip, image=img, spacing=np.asarray(spacing, np.float32))
        else:
            np.save(ip, img)
        np.save(lp, lab)
        np.save(zp, (lab > 0).astype(np.uint8))
        row = {"p-id": f"raw{i}", "image_path": ip, "label_path": lp, "zones_path": zp}
        if spacing is not None and not npz:
            row["spacing"] = "x".join(str(s) for s in spacing)
        rows.append(row)
    man = os.path.join(tmp, "raw.csv")
    with open(man, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return man


def relative_manifest(path, out_dir):
    with open(path) as f:
        return f.read().replace(out_dir + os.sep, "<out>/")


CASES = {
    "at_target_spacing": (dict(), ["--SIZE", "8", "32", "32", "--FOLDS", "3"]),
    "spacing_column": (dict(spacing=(3.0, 1.0, 1.0)),
                       ["--SIZE", "12", "64", "64", "--SPACING", "3.0", "0.5", "0.5",
                        "--FOLDS", "2", "--SEED", "4"]),
    "npz_spacing": (dict(spacing=(3.0, 1.0, 1.0), npz=True),
                    ["--SIZE", "6", "48", "48", "--SPACING", "2.0", "0.75", "0.75",
                     "--FOLDS", "0", "--WHITEN_PERCENTILE", "0"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ingest_writes_what_jax_ingest_writes(case, tmp_path):
    raw_kw, flags = CASES[case]
    man = write_raw(str(tmp_path / "raw"), **raw_kw)
    outs = {}
    for name, mod in (("jax", jingest), ("port", ingest)):
        out = str(tmp_path / name)
        outs[name] = (out, mod.main(["--MANIFEST", man, "--OUTPUT_DIR", out, *flags]))
    (jout, jwritten), (pout, pwritten) = outs["jax"], outs["port"]
    assert [os.path.relpath(p, pout) for p in pwritten] == \
        [os.path.relpath(p, jout) for p in jwritten]
    assert sorted(os.listdir(pout)) == sorted(os.listdir(jout))
    volumes = [f for f in os.listdir(jout) if f.endswith(".npy")]
    assert len(volumes) == 18
    for f in sorted(os.listdir(jout)):
        if f.endswith(".npy"):
            with open(os.path.join(jout, f), "rb") as a, open(os.path.join(pout, f), "rb") as b:
                assert a.read() == b.read(), f
        else:
            assert relative_manifest(os.path.join(pout, f), pout) == \
                relative_manifest(os.path.join(jout, f), jout), f
    rows = read_manifest(pwritten[0])
    image, label = np.load(rows[0]["image_path"]), np.load(rows[0]["label_path"])
    size = tuple(int(v) for v in flags[1:4])
    assert image.shape == (*size, 3) and label.shape == size
    assert set(np.unique(label)) <= {0, 2, 3} and label.dtype == np.uint8


def test_ingest_error_paths(tmp_path):
    """Contradictory manifest and npz spacings, more folds than cases and an
    ambiguous npz raise as in the JAX package."""
    tmp = str(tmp_path)
    man = write_raw(os.path.join(tmp, "npz"), n=2, shape=(6, 16, 16), spacing=(3.0, 1.0, 1.0),
                    npz=True)
    rows = read_manifest(man)
    for r in rows:
        r["spacing"] = "3.0x2.0x2.0"  # disagrees with the embedded (3, 1, 1)
    man2 = os.path.join(tmp, "raw2.csv")
    with open(man2, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    for mod in (jingest, ingest):
        with pytest.raises(ValueError, match="contradicts"):
            mod.main(["--MANIFEST", man2, "--OUTPUT_DIR", os.path.join(tmp, "f1"),
                      "--SIZE", "6", "16", "16", "--SPACING", "3.0", "0.5", "0.5",
                      "--FOLDS", "0"])
    man3 = write_raw(os.path.join(tmp, "few"), n=3)
    with pytest.raises(ValueError, match="at least 5 cases"):
        ingest.main(["--MANIFEST", man3, "--OUTPUT_DIR", os.path.join(tmp, "f2"),
                     "--SIZE", "8", "32", "32", "--FOLDS", "5"])
    amb = os.path.join(tmp, "amb.npz")
    np.savez(amb, a=np.zeros((4, 8, 8), np.float32), b=np.zeros((4, 8, 8), np.float32))
    with pytest.raises(ValueError, match="ambiguous npz"):
        ingest.ingest_case({"p-id": "x", "image_path": amb, "label_path": "",
                            "zones_path": ""}, tmp, size=(4, 8, 8))
    flat = os.path.join(tmp, "flat.npz")
    np.savez(flat, image=np.zeros((8, 8), np.float32))
    with pytest.raises(ValueError, match=r"must be \(D,H,W\[,C\]\)"):
        ingest.ingest_case({"p-id": "y", "image_path": flat, "label_path": "",
                            "zones_path": ""}, tmp, size=(4, 8, 8))
