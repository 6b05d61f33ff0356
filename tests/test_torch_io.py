"""Port parity for tpu3dm_torch's I/O (CPU): the PLY reader and writer
(io/ply.py) and host.cpp's ASCII parser against the JAX package and its
native tier, the synthetic families, the threaded loader (io/loader.py), and
first-use builds of the csrc libraries from many threads at once.

The PLY reader, the parser and the synthetic families are held bit for bit:
they are the same NumPy and C++ code on the same bytes and seeds.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import tpu3dm.native
from tpu3dm.io import ply as jply
from tpu3dm.io import synthetic as jsyn
from tpu3dm.io.loader import preprocess_files_batch as j_files_batch
from tpu3dm.core.config import PipelineConfig
from tpu3dm_torch import csrc
from tpu3dm_torch.core.config import PipelineConfig as PConfig
from tpu3dm_torch.io import loader as ploader
from tpu3dm_torch.io import ply as pply
from tpu3dm_torch.io import synthetic as psyn

from test_torch_host import native_tier  # noqa: F401  (module fixture: JAX's native tier)
from test_torch_ingest import _assert_features_agree

CFG = PipelineConfig.with_voxel_size(0.3)
PCFG = PConfig.with_voxel_size(0.3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cloud(n=500, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 3.0
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, nrm, rng.uniform(0, 1, size=(n, 3))


def _same_read(path):
    """Both readers on one file: the same keys and bit-equal arrays, or the
    same exception type and message."""
    try:
        want = jply.read_ply(path)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pply.read_ply(path)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return None
    got = pply.read_ply(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    return got


def _header(fmt, n_vertex, vertex_props, extra=""):
    lines = ["ply", f"format {fmt} 1.0", "comment hand-written", f"element vertex {n_vertex}"]
    lines += [f"property {t} {name}" for t, name in vertex_props]
    return ("\n".join(lines) + "\n" + extra + "end_header\n").encode("ascii")


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("fields", ["points", "normals", "colors", "all"])
def test_write_ply_matches_jax_and_reads_back(tmp_path, binary, fields):
    """The two writers write the same bytes; both readers read them the
    same, uchar colours scaled to [0, 1]."""
    pts, nrm, col = _cloud()
    kw = dict(binary=binary, normals=nrm if fields in ("normals", "all") else None,
              colors=col if fields in ("colors", "all") else None)
    jply.write_ply(tmp_path / "j.ply", pts, **kw)
    pply.write_ply(tmp_path / "p.ply", pts, **kw)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "p.ply").read_bytes()
    got = _same_read(tmp_path / "p.ply")
    np.testing.assert_array_equal(got["points"], pts)
    if kw["colors"] is not None:
        np.testing.assert_array_equal(got["colors"], np.round(col * 255) / 255.0)


@pytest.mark.parametrize("endian", ["<", ">"])
def test_read_ply_binary_endianness_and_faces(tmp_path, endian):
    """float32 points, uchar colours and a face element (a list property,
    skipped) in both byte orders."""
    pts, _, col = _cloud(64, seed=1)
    fmt = "binary_little_endian" if endian == "<" else "binary_big_endian"
    props = [("float", "x"), ("float", "y"), ("float", "z"), ("uchar", "red"),
             ("uchar", "green"), ("uchar", "blue")]
    faces = "element face 3\nproperty list uchar int vertex_indices\n"
    dt = np.dtype([("x", endian + "f4"), ("y", endian + "f4"), ("z", endian + "f4"),
                   ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec = np.zeros(64, dt)
    for i, c in enumerate("xyz"):
        rec[c] = pts[:, i]
    for i, c in enumerate(("red", "green", "blue")):
        rec[c] = np.round(col[:, i] * 255)
    face = b"".join(bytes([3]) + np.array([i, i + 1, i + 2], endian + "i4").tobytes()
                    for i in range(3))
    path = tmp_path / "cloud.ply"
    path.write_bytes(_header(fmt, 64, props, faces) + rec.tobytes() + face)
    got = _same_read(path)
    np.testing.assert_array_equal(got["points"], pts.astype(np.float32).astype(np.float64))


def test_read_ply_ascii_with_faces_takes_the_token_path(tmp_path):
    pts, _, _ = _cloud(20, seed=2)
    body = "".join(" ".join(repr(float(v)) for v in p) + "\n" for p in pts)
    body += "3 0 1 2\n4 0 1 2 3\n"
    path = tmp_path / "faces.ply"
    path.write_bytes(_header("ascii", 20, [("double", c) for c in "xyz"],
                             "element face 2\nproperty list uchar int vertex_indices\n")
                     + body.encode("ascii"))
    np.testing.assert_array_equal(_same_read(path)["points"], pts)


@pytest.mark.parametrize("case", ["vertex_list", "truncated_binary", "truncated_ascii",
                                  "bad_token", "empty", "no_magic", "no_xyz"])
def test_read_ply_malformed_files_raise_as_jax(tmp_path, native_tier, case):  # noqa: F811
    """Each malformed file raises the same exception type and message in
    both packages (PlyError, or ValueError for an empty cloud)."""
    assert tpu3dm.native.available()
    xyz = [("float", c) for c in "xyz"]
    ascii3 = b"1 2 3\n4 5 6\n"
    files = {
        "vertex_list": _header("ascii", 1, xyz + [("list uchar int", "idx")]) + b"1 2 3 0\n",
        "truncated_binary": _header("binary_little_endian", 4, xyz) + b"\0" * 20,
        "truncated_ascii": _header("ascii", 3, xyz) + ascii3,
        "bad_token": _header("ascii", 2, xyz) + b"1 2 3\n4 x 6\n",
        "empty": _header("binary_little_endian", 0, xyz),
        "no_magic": b"plx\n" + _header("ascii", 2, xyz)[4:] + ascii3,
        "no_xyz": _header("ascii", 2, [("float", c) for c in "xyw"]) + ascii3,
    }
    path = tmp_path / f"{case}.ply"
    path.write_bytes(files[case])
    with pytest.raises(ValueError):
        jply.read_ply(path)
    assert _same_read(path) is None


@pytest.mark.parametrize("buf, expected", [
    (b"1 2 3", 3),
    (b"  -1.5e-3\t+2.25\r\n3e10 \n\n 4.0000000000000001 5 ", 5),
    (b"0x1p-3 inf -inf 1e-320", 4),  # strtod's hex, infinities, subnormals
    (b"1 2 3 4 5", 3),  # stops at the count asked for
    (b"1 2", 3),  # too few
    (b"1 2 abc", 3),  # malformed token
    (b"", 0),
])
def test_parse_floats_matches_jax_native_tier(native_tier, buf, expected):  # noqa: F811
    """host.cpp's t3n_parse_floats against the JAX native tier's: the same
    float64 bits, or the same error."""
    assert tpu3dm.native.available()
    try:
        want = tpu3dm.native.parse_floats(buf, expected)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pply.parse_floats(buf, expected)
        assert str(got.value) == str(e)
        return
    np.testing.assert_array_equal(pply.parse_floats(buf, expected).view(np.int64),
                                  want.view(np.int64))


def test_parse_floats_needs_bytes():
    """strtod stops at the NUL that terminates a bytes object only."""
    with pytest.raises(TypeError):
        pply.parse_floats(bytearray(b"1 2 3"), 3)


def test_read_ply_many_keeps_order_and_names_the_bad_path(tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / f"c{i}.ply"
        pply.write_ply(p, _cloud(50 + i, seed=i)[0], binary=bool(i % 2))
        paths.append(p)
    serial = [pply.read_ply(p) for p in paths]
    for workers in (1, 4):
        got = ploader.read_ply_many(paths, workers=workers)
        for a, b in zip(got, serial):
            np.testing.assert_array_equal(a["points"], b["points"])
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(pply.PlyError, match="bad.ply"):
        ploader.read_ply_many(paths[:3] + [bad] + paths[3:], workers=4)
    assert ploader.read_ply_many([]) == []


# ---------------------------------------------------------------------------
# Synthetic families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name, kw", [
    ("plate_with_holes_cloud", dict(n=3000)),
    ("plate_with_holes_cloud", dict(n=2000, noise=0.01)),
    ("scanned_arch_cloud", dict(n=3000)),
    ("scanned_arch_cloud", dict(n=2000, view=(2.5, -6.5, 7.0))),
    ("dental_arch_cloud", dict(n=2000, noise=0.01)),
])
def test_families_equal_jax(name, kw, seed):
    np.testing.assert_array_equal(getattr(psyn, name)(seed=seed, **kw),
                                  getattr(jsyn, name)(seed=seed, **kw))


@pytest.mark.parametrize("family", ["arch", "plate", "scan"])
@pytest.mark.parametrize("overlap", [1.0, 0.7])
def test_make_benchmark_pair_equals_jax(family, overlap):
    for a, b in zip(psyn.make_benchmark_pair(2500, seed=3, sigma=0.01, overlap=overlap,
                                             family=family),
                    jsyn.make_benchmark_pair(2500, seed=3, sigma=0.01, overlap=overlap,
                                             family=family)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="family"):
        psyn.make_benchmark_pair(100, family="cube")


# ---------------------------------------------------------------------------
# The window iterator
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Five pairs of the three families (1500 points) as binary PLYs."""
    d = tmp_path_factory.mktemp("manifest")
    pairs = []
    for i in range(5):
        s, t, _ = psyn.make_benchmark_pair(1500, seed=i, sigma=0.005,
                                           family=("arch", "plate", "scan")[i % 3])
        sp, tp = d / f"s{i}.ply", d / f"t{i}.ply"
        pply.write_ply(sp, s.astype(np.float32))
        pply.write_ply(tp, t.astype(np.float32))
        pairs.append((str(sp), str(tp)))
    return pairs


def test_preprocess_files_batch_matches_jax(manifest):
    paths = [p for pair in manifest[:2] for p in pair]
    got = ploader.preprocess_files_batch(paths, PCFG.preprocess, full_normals=False,
                                         workers=3, device="cpu")
    want = j_files_batch(paths, CFG.preprocess, full_normals=False, workers=3)
    for p, j in zip(got, want):
        _assert_features_agree(p.down, j.down)


@pytest.mark.parametrize("window", [2, 3])
def test_iter_preprocessed_windows_equals_per_window_batches(manifest, window):
    """Each window's clouds are its sorted distinct paths through
    preprocess_files_batch, bit for bit; skipped paths are not ingested."""
    skip = {manifest[1][0], manifest[4][1]}
    seen = []
    for idxs, procs in ploader.iter_preprocessed_windows(
            manifest, PCFG.preprocess, window=window, workers=2, skip_paths=skip,
            full_normals=False, device="cpu"):
        seen += idxs
        uniq = sorted({p for i in idxs for p in manifest[i] if p not in skip})
        assert sorted(procs) == uniq
        direct = ploader.preprocess_files_batch(uniq, PCFG.preprocess, full_normals=False,
                                                device="cpu")
        for path, d in zip(uniq, direct):
            for f in ("points", "mask", "normals", "features"):
                assert torch.equal(getattr(procs[path].down, f), getattr(d.down, f))
    assert seen == list(range(len(manifest)))
    with pytest.raises(ValueError, match="window"):
        ploader.iter_preprocessed_windows(manifest, PCFG.preprocess, window=0, device="cpu")


def test_iter_preprocessed_windows_forwards_the_producers_error(manifest, tmp_path):
    """A bad file in window 2 raises in the consumer, naming its path, after
    window 1 was yielded; the producer thread has ended by then."""
    bad = tmp_path / "broken.ply"
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 2\n")
    pairs = manifest[:2] + [(manifest[2][0], str(bad))]
    before = threading.active_count()
    windows = ploader.iter_preprocessed_windows(pairs, PCFG.preprocess, window=2,
                                                full_normals=False, device="cpu")
    first = next(windows)
    assert first[0] == [0, 1]
    with pytest.raises(pply.PlyError, match="broken.ply"):
        next(windows)
    assert threading.active_count() == before
    # Stopping early drains the producer too.
    for _ in ploader.iter_preprocessed_windows(manifest, PCFG.preprocess, window=1,
                                               full_normals=False, device="cpu"):
        break
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# First-use builds shared by threads
# ---------------------------------------------------------------------------


def test_first_use_build_and_load_from_eight_threads(tmp_path, monkeypatch):
    """Eight threads call host_library() and read an ASCII PLY (host.cpp's
    parser) at once on an empty build directory: one build, one library,
    no temp file left, every call succeeds with the same cloud."""
    monkeypatch.setattr(csrc, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(csrc, "_host_lib", None)
    builds = []
    real_build = csrc._build

    def counted(sources):
        builds.append(list(sources))
        return real_build(sources)

    monkeypatch.setattr(csrc, "_build", counted)
    pts = _cloud(300, seed=5)[0]
    path = tmp_path / "ascii.ply"
    pply.write_ply(path, pts, binary=False)
    start = threading.Barrier(8)
    results, errors, libs = [None] * 8, [], [None] * 8

    def worker(k):
        try:
            start.wait(timeout=60)
            libs[k] = csrc.host_library()
            results[k] = pply.read_ply(path)["points"]
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert builds == [[csrc.HOST_SOURCE]]
    assert all(lib is libs[0] for lib in libs)
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert [n for n in built if n.endswith(".so")] == [csrc.library_path(csrc.HOST_SOURCE).name]
    assert not [n for n in built if n.endswith(".tmp")]
    for r in results:
        np.testing.assert_array_equal(r, pts)
