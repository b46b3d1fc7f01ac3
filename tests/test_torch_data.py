"""The port's dataset module (dgpmp2_tpu_torch.data) against the JAX
package's: the on-disk format both ways, the PNG codec against matplotlib's
reader and writer, the split and the batches.  Exact equality throughout:
both sides are numpy on the same files."""
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dgpmp2_tpu.data import dataset as jds  # noqa: E402
from dgpmp2_tpu_torch.data import dataset as tds  # noqa: E402
from dgpmp2_tpu_torch.data import png  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _write(mod, root, seed=0, n_envs=3, ppe=2, n=16, t=6, binary=True):
    """A small dataset under ``root`` written through ``mod``'s writers."""
    rng = np.random.default_rng(seed)
    d = root / "train"
    for e in range(n_envs):
        im = (rng.uniform(size=(n, n)) > 0.2).astype(np.float64)
        if not binary:
            im = rng.uniform(-2.0, 3.0, (n, n))
        sdf = rng.standard_normal((n, n)).astype(np.float32)
        mod.save_env(str(d), e, im, sdf)
        for j in range(ppe):
            lab = dict(start=rng.standard_normal(4), goal=rng.standard_normal(4),
                       th_opt=rng.standard_normal((t + 1, 4)))
            th_init = rng.standard_normal((t + 1, 4)) if j else None
            mod.save_problem(str(d), e, j, "opt_trajs_gpmp2", **lab,
                             th_init=th_init)
    mod.save_meta(str(d), n_envs, ppe, n, extra={"family": "test"})


@pytest.mark.parametrize("writer,reader", [(jds, tds), (tds, jds)],
                         ids=["jax_written_port_reads",
                              "port_written_jax_reads"])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "grey"])
def test_a_dataset_written_by_one_package_reads_in_the_other(
        tmp_path, writer, reader, binary):
    _write(writer, tmp_path, binary=binary)
    got = reader.PlanningDataset(str(tmp_path))
    want = writer.PlanningDataset(str(tmp_path))
    assert len(got) == len(want) == 6
    assert got.meta == want.meta
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_the_port_writes_the_files_the_jax_package_writes(tmp_path):
    """Byte-equal npz and YAML; the PNG's pixels equal (matplotlib adds its
    own metadata chunk)."""
    for mod, sub in ((jds, "j"), (tds, "t")):
        _write(mod, tmp_path / sub, binary=False)
    for path in (tmp_path / "j").rglob("*"):
        other = tmp_path / "t" / path.relative_to(tmp_path / "j")
        if path.is_dir():
            continue
        if path.suffix == ".png":
            assert np.array_equal(plt.imread(path), plt.imread(other))
        elif path.suffix == ".npz":
            a, b = np.load(path), np.load(other)
            assert a.files == b.files
            assert all(np.array_equal(a[k], b[k]) for k in a.files)
        else:
            assert path.read_bytes() == other.read_bytes(), path


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint8, bool])
def test_gray_rgba_is_what_imsave_writes(tmp_path, dtype):
    rng = np.random.default_rng(3)
    x = rng.uniform(-3.0, 7.0, (20, 31))
    x = (x > 2.0) if dtype is bool else x.astype(dtype)
    plt.imsave(tmp_path / "m.png", x, cmap="gray")
    assert np.array_equal(png.gray_rgba(x),
                          np.round(plt.imread(tmp_path / "m.png") * 255))
    png.write_png(tmp_path / "p.png", png.gray_rgba(x))
    assert np.array_equal(plt.imread(tmp_path / "p.png"),
                          plt.imread(tmp_path / "m.png"))
    # A constant image: matplotlib's normalisation gives 0 (black).
    assert not png.gray_rgba(np.ones((3, 3)))[..., :3].any()


def _png_bytes(px: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit PNG of ``px`` (H, W, C) whose row r uses filter
    ``filters[r % len(filters)]``."""
    h, w, c = px.shape
    raw = px.reshape(h, w * c).astype(np.int32)
    rows = []
    prev = np.zeros(w * c, np.int32)
    for r in range(h):
        f = filters[r % len(filters)]
        cur = raw[r]
        a = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        cprev = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (a + prev) >> 1
        else:
            pa, pb = np.abs(prev - cprev), np.abs(a - cprev)
            pc = np.abs(a + prev - 2 * cprev)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, cprev))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8)
                    .tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_read_png_takes_every_colour_type_and_filter(tmp_path, ctype):
    """Colour types 0/2/4/6, rows cycling through the five filter types,
    read as matplotlib's imread reads them."""
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    px = np.random.default_rng(ctype).integers(0, 256, (11, 9, c),
                                               dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes(px, ctype, (0, 1, 2, 3, 4)))
    got, want = png.read_png(path), plt.imread(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and np.array_equal(got, want)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(path)
    plt.imsave(tmp_path / "ok.png", np.eye(4), cmap="gray")
    data = bytearray((tmp_path / "ok.png").read_bytes())
    data[-20] ^= 0xFF  # inside the last chunks: a CRC no longer matches
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(path)


def test_split_and_batches_match_jax(tmp_path):
    _write(tds, tmp_path, n_envs=4, ppe=3)
    ds_t, ds_j = tds.PlanningDataset(str(tmp_path)), jds.PlanningDataset(
        str(tmp_path))
    for shuffle in (True, False):
        a = tds.train_valid_split(12, 0.25, np.random.default_rng(5),
                                  shuffle)
        b = jds.train_valid_split(12, 0.25, np.random.default_rng(5),
                                  shuffle)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for drop in (True, False):
        got = list(tds.as_batches(ds_t, range(12), 5,
                                  np.random.default_rng(1), drop))
        want = list(jds.as_batches(ds_j, range(12), 5,
                                   np.random.default_rng(1), drop))
        assert len(got) == len(want) == (2 if drop else 3)
        for a, b in zip(got, want):
            assert all(np.array_equal(a[k], b[k]) for k in b)


def test_multi_root_routing_and_caps_match_jax(tmp_path):
    for i in range(2):
        _write(tds, tmp_path / f"r{i}", seed=i, n_envs=2 + i, ppe=2)
    roots = [str(tmp_path / "r0"), str(tmp_path / "r1")]
    t, j = tds.PlanningDatasetMulti(roots), jds.PlanningDatasetMulti(roots)
    assert len(t) == len(j) == 10
    for i in (0, 3, 4, 9):
        assert np.array_equal(t[i]["th_opt"], j[i]["th_opt"])
    capped = tds.PlanningDatasetMulti(roots, num_envs=1, num_env_probs=1)
    assert len(capped) == 2
    with pytest.raises(ValueError, match="requested num_envs=5"):
        tds.PlanningDataset(roots[0], num_envs=5)


def test_the_dataset_path_never_imports_matplotlib(tmp_path):
    _write(tds, tmp_path)
    code = (
        "import sys\n"
        "from dgpmp2_tpu_torch.data import dataset as ds\n"
        f"d = ds.PlanningDataset({str(tmp_path)!r})\n"
        "b = next(ds.as_batches(d, range(len(d)), 2))\n"
        f"ds.save_env({str(tmp_path / 'w')!r}, 0, b['im'][0], b['sdf'][0])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'PIL', 'jax', 'dgpmp2_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
