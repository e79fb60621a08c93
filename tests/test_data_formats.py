"""Real-format parser round-trips: every on-disk ingestion path is
exercised against a crafted fixture (no synthetic fallback), so a
malformed parser cannot ship silently.

Reference formats: MD17 ``<mol>_dft.npz`` (R/E/F/z,
``scripts/md17/run.py:9-17``), QM9 ``train.npz`` named targets + thermo
columns (``scripts/qm9_full/run.py:10-18``), ANI HDF5 shards
(``scripts/ani/data.py:20-48``), OC20 lmdb of pickled Data objects
(``scripts/oc20_batch/data.py:7-16``), ISO17 ``ase.db`` rows
(``scripts/iso17/run.py:9-33``). lmdb/ase are not installed in this
image, so those two parsers run against faithful in-memory fakes of the
library surface with REAL pickled payloads.
"""

import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def test_md17_synthetic_molecule_compositions():
    """The synthetic fallback honors the molecule name: every MD17
    molecule the reference trains on (``scripts/md17/run.py`` takes any
    ``<name>_dft.npz``) synthesizes with its true composition, and the
    surrogate forces stay consistent with the energies (-dE/dx checked
    by finite difference on one coordinate)."""
    from sake_tpu.data.md17 import MD17_Z, _surrogate_energy_forces, load_md17

    expect_atoms = {"aspirin": 21, "benzene": 12, "ethanol": 9,
                    "malonaldehyde": 9, "naphthalene": 18, "salicylic": 16,
                    "toluene": 15, "uracil": 12}
    for mol, n in expect_atoms.items():
        data = load_md17(mol, n_samples=4)
        assert data.x.shape == (4, n, 3), mol
        assert data.z.tolist() == MD17_Z[mol].tolist()

    z = MD17_Z["ethanol"].astype(np.float64)
    x = np.random.RandomState(0).randn(2, len(z), 3) * 2.0
    _, f0 = _surrogate_energy_forces(x, z)
    eps = 1e-3  # centered difference; outputs are f32 so tiny eps drowns
    xp, xm = x.copy(), x.copy()
    xp[:, 3, 1] += eps
    xm[:, 3, 1] -= eps
    ep, _ = _surrogate_energy_forces(xp, z)
    em, _ = _surrogate_energy_forces(xm, z)
    np.testing.assert_allclose(
        -(ep - em).ravel() / (2 * eps), f0[:, 3, 1], rtol=2e-3, atol=2e-4
    )


def test_md17_npz_roundtrip_and_train(tmp_path):
    from sake_tpu.data.md17 import load_md17

    rng = np.random.RandomState(0)
    n, ns = 5, 12
    z = np.array([6, 6, 8, 1, 1], np.int64)
    R = rng.randn(ns, n, 3)
    E = rng.randn(ns, 1)
    F = rng.randn(ns, n, 3)
    np.savez(tmp_path / "aspirin_dft.npz", R=R, E=E, F=F, z=z)

    data = load_md17("aspirin", data_dir=str(tmp_path))
    assert data.x.shape == (ns, n, 3) and data.f.shape == (ns, n, 3)
    assert data.z.tolist() == z.tolist()
    # the loader applies the reference's seed-2666 permutation
    perm = np.random.RandomState(2666).permutation(ns)
    np.testing.assert_allclose(data.e, E[perm].astype(np.float32))

    # one real training step through the task's E+F machinery
    from sake_tpu.tasks.md17 import MD17Config, init_params, make_energy_force_fn

    sp = jax.nn.one_hot(data.z, data.z.max())
    x0 = jnp.asarray(data.x[:4])
    params = init_params(MD17Config(hidden_features=8, depth=2), sp.shape[-1])
    ef = make_energy_force_fn(4, sp, 0.0, 1.0)

    def loss(p):
        e, f = ef(p, x0)
        return (
            jnp.abs(f - jnp.asarray(data.f[:4])).mean()
            + 1e-3 * jnp.abs(e.ravel() - jnp.asarray(data.e[:4]).ravel()).mean()
        )

    l, g = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(l))
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(g))


def test_qm9_named_target_thermo(tmp_path):
    from sake_tpu.data.qm9 import load_qm9

    rng = np.random.RandomState(1)
    B, N = 6, 9
    charges = rng.choice([0, 1, 6, 8], size=(B, N)).astype(np.int32)
    pos = rng.randn(B, N, 3).astype(np.float32)
    U0 = rng.randn(B).astype(np.float32)
    U0_thermo = rng.randn(B).astype(np.float32)
    np.savez(
        tmp_path / "train.npz",
        charges=charges, positions=pos, U0=U0, U0_thermo=U0_thermo,
    )
    d = load_qm9(str(tmp_path), target="U0")
    np.testing.assert_allclose(
        d.y.ravel(), U0 - U0_thermo, rtol=1e-6
    )
    d2 = load_qm9(str(tmp_path), target="U0", subtract_thermo=False)
    np.testing.assert_allclose(d2.y.ravel(), U0, rtol=1e-6)


def test_qm9_energy_target_atomization_offsets(tmp_path):
    """Without shipped thermo columns, total-energy targets get the
    per-element reference energies subtracted (ATOM_REF_ENERGY)."""
    from sake_tpu.data.qm9 import ATOM_REF_ENERGY, load_qm9

    B, N = 3, 4
    charges = np.array(
        [[1, 1, 6, 8], [6, 6, 0, 0], [9, 1, 0, 0]], np.int32
    )
    pos = np.zeros((B, N, 3), np.float32)
    U0 = np.array([1.0, 2.0, 3.0], np.float32)
    np.savez(tmp_path / "train.npz", charges=charges, positions=pos, U0=U0)
    d = load_qm9(str(tmp_path), target="U0")
    want = U0 - np.array(
        [sum(ATOM_REF_ENERGY.get(int(z), 0.0) for z in row) for row in charges],
        np.float32,
    )
    np.testing.assert_allclose(d.y.ravel(), want, rtol=1e-5)


def test_qm9_int_target_column(tmp_path):
    from sake_tpu.data.qm9 import load_qm9

    rng = np.random.RandomState(2)
    B, N = 4, 5
    i = rng.choice([0, 1, 6], size=(B, N)).astype(np.int32)
    x = rng.randn(B, N, 3).astype(np.float32)
    y = rng.randn(B, 3).astype(np.float32)  # 3 targets
    np.savez(tmp_path / "qm9.npz", i=i, x=x, y=y)
    d = load_qm9(str(tmp_path), target=2)
    np.testing.assert_allclose(d.y.ravel(), y[:, 2], rtol=1e-6)


def test_ani_hdf5_roundtrip(tmp_path):
    import h5py

    from sake_tpu.data.ani import ELEMENT_ENERGY, load_ani_hdf5

    rng = np.random.RandomState(3)
    z = np.array([6, 1, 1, 8], np.int64)
    coords = rng.randn(3, 4, 3).astype(np.float32)  # 3 conformers
    energies = rng.randn(3).astype(np.float64)
    path = tmp_path / "ani_shard0.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("g0")
        mol = g.create_group("mol0")
        mol["atomic_numbers"] = z
        mol["coordinates"] = coords
        mol["energies"] = energies

    samples = load_ani_hdf5([str(path)])
    assert len(samples) == 3
    offset = sum(ELEMENT_ENERGY[int(zi)] for zi in z)
    for s, e_raw, x_raw in zip(samples, energies, coords):
        assert s["z"].tolist() == z.tolist()
        np.testing.assert_allclose(s["x"], x_raw)
        np.testing.assert_allclose(
            s["e"], np.float32(e_raw - offset), rtol=1e-5
        )


def test_oc20_lmdb_parse(monkeypatch):
    """Exercise the lmdb decode path (pickled Data objects with
    ``atomic_numbers``/``pos``/``y_relaxed``) against a faithful fake of
    the lmdb API carrying REAL pickled payloads."""
    from sake_tpu.data import oc20 as oc20_mod

    rng = np.random.RandomState(4)
    records = []
    for i in range(3):
        n = 4 + i
        d = types.SimpleNamespace(
            atomic_numbers=rng.choice([1, 6, 78], size=n).astype(np.int64),
            pos=rng.randn(n, 3).astype(np.float64),
            y_relaxed=float(rng.randn()),
        )
        records.append((str(i).encode(), pickle.dumps(d), d))

    class FakeTxn:
        def get(self, k):
            return b"3" if k == b"length" else None

        def cursor(self):
            return [(k, v) for k, v, _ in records] + [(b"length", b"3")]

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class FakeEnv:
        def begin(self):
            return FakeTxn()

    fake_lmdb = types.ModuleType("lmdb")
    fake_lmdb.open = lambda *a, **k: FakeEnv()
    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)

    samples = oc20_mod.load_oc20_lmdb("/nonexistent.lmdb")
    assert len(samples) == 3
    for s, (_, _, d) in zip(samples, records):
        assert s["z"].tolist() == list(d.atomic_numbers)
        np.testing.assert_allclose(s["x"], d.pos.astype(np.float32))
        np.testing.assert_allclose(s["e"], np.float32(d.y_relaxed))


def test_iso17_db_parse(monkeypatch):
    """Exercise the ase.db row-decoding path (positions, total_energy,
    data['atomic_forces']) against a faithful fake of the ase.db API."""
    from sake_tpu.data import iso17 as iso17_mod

    rng = np.random.RandomState(5)
    n = len(iso17_mod.ISO17_Z)

    class FakeRow:
        """ase rows: attribute access for positions/data, dict-style
        access for scalar key/value pairs."""

        def __init__(self):
            self.positions = rng.randn(n, 3)
            self.data = {"atomic_forces": rng.randn(n, 3)}

        def __contains__(self, k):
            return k == "total_energy"

        def __getitem__(self, k):
            assert k == "total_energy"
            return 1.25

    rows = [FakeRow() for _ in range(4)]

    class FakeDB:
        def select(self):
            return iter(rows)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    fake_db = types.ModuleType("ase.db")
    fake_db.connect = lambda path: FakeDB()
    fake_ase = types.ModuleType("ase")
    fake_ase.db = fake_db
    monkeypatch.setitem(sys.modules, "ase", fake_ase)
    monkeypatch.setitem(sys.modules, "ase.db", fake_db)

    d = iso17_mod.load_iso17_db("/nonexistent.db")
    assert d.x.shape == (4, n, 3) and d.f.shape == (4, n, 3)
    np.testing.assert_allclose(d.e.ravel(), [1.25] * 4)
    np.testing.assert_allclose(d.f[0], rows[0].data["atomic_forces"])


def test_ani_smiles_inventory(tmp_path):
    """SMILES inventory over HDF5 shards (scripts/ani/smiles.py parity):
    per-character smiles arrays joined, JSON output, groups without a
    smiles field inventoried by name."""
    import json

    import h5py

    from sake_tpu.data.ani import smiles_inventory

    path = tmp_path / "ani_shard0.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("g0")
        mol = g.create_group("mol0")
        mol["atomic_numbers"] = np.array([6, 1], np.int64)
        mol["smiles"] = np.array([b"C", b"C", b"O"])
        bare = g.create_group("mol1_noname")
        bare["atomic_numbers"] = np.array([8], np.int64)

    out = tmp_path / "smiles.json"
    got = smiles_inventory([str(path)], str(out))
    assert got == ["CCO", "mol1_noname"]
    assert json.load(open(out)) == got
