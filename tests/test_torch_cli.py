"""tpu3dm_torch.apps.cli against tpu3dm.apps.cli, on the CPU (``--device cpu``).

The parser has JAX's subcommands, option names and defaults, plus
``--device``; default output files are JAX's names under ``torch_runs/``
(which .gitignore lists), so no default names a file git tracks.
``convert`` and ``trim`` write JAX's bytes; ``register`` lands in the gate
and within 0.5 deg / 0.02 of JAX's pose on the same files; the other
subcommands run end to end.
"""

import argparse
import inspect
import json
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu3dm.apps import cli as jcli
from tpu3dm.io.ply import write_ply as j_write_ply
from tpu3dm.io.synthetic import dental_arch_cloud, make_benchmark_pair
from tpu3dm_torch.apps import benchmark, cli, kernelbench

ROOT = Path(__file__).resolve().parents[1]
OUT_OPTIONS = {"out", "out_txt", "out_json"}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clouds")
    src, tgt, T = make_benchmark_pair(4000, seed=1, sigma=0.005)
    j_write_ply(d / "src.ply", src)
    j_write_ply(d / "tgt.ply", tgt)
    return d / "src.ply", d / "tgt.ply", T


def _subparsers(ap):
    (action,) = [a for a in ap._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(p):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs)
            for a in p._actions if a.dest != "help"}


def test_parser_has_jax_subcommands_options_and_defaults():
    jsub, psub = _subparsers(jcli.build_parser()), _subparsers(cli.build_parser())
    assert list(psub) == list(jsub)
    for name, jp in jsub.items():
        want = _options(jp)
        got = _options(psub[name])
        assert got.pop("device") == (("--device",), "cuda", None), name
        for dest in OUT_OPTIONS & set(want):
            opts, default, nargs = want[dest]
            want[dest] = (opts, f"torch_runs/{Path(default).name}", nargs)
        assert got == want, name
        assert psub[name]._defaults["fn"] is not None


def test_reargs_round_trips():
    ap = cli.build_parser()
    a = ap.parse_args(
        ["bench", "--serve", "5", "--serve-clients", "2", "--multiway", "4",
         "--fpfh-ab", "--overlap-sweep", "--scaling-model", "--track-memory",
         "--sweep", "--sweep-counts", "64,128", "--scaling", "--mesh-sizes", "1,2",
         "--stream", "3", "--stream-ab", "--device", "cpu"]
    )
    out = cli._reargs(a)
    for flag in ("--serve", "--multiway", "--fpfh-ab", "--overlap-sweep",
                 "--scaling-model", "--track-memory", "--serve-clients",
                 "--serve-distinct", "--sweep-counts", "--mesh-sizes", "--stream-ab"):
        assert flag in out, (flag, out)
    bp = argparse.ArgumentParser()
    benchmark.add_args(bp)
    b = bp.parse_args(out)
    for k, v in vars(b).items():
        assert getattr(a, k) == v, k
    assert b.device == "cpu"


def _default_outputs() -> dict[str, str]:
    """Every default output path of tpu3dm_torch.apps: the parsers' output
    options and the runners' ``out_*`` / ``roofline_json`` parameters."""
    found = {}
    for name, p in _subparsers(cli.build_parser()).items():
        for a in p._actions:
            if a.dest in OUT_OPTIONS:
                found[f"cli {name} {a.dest}"] = a.default
    for mod in (benchmark, kernelbench):
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            for pname, param in inspect.signature(fn).parameters.items():
                if (pname.startswith("out") or pname == "roofline_json") and \
                        isinstance(param.default, str):
                    found[f"{mod.__name__}.{fname} {pname}"] = param.default
    return found


def test_no_default_output_names_a_tracked_file():
    outs = _default_outputs()
    assert len(outs) >= 15
    assert "torch_runs/" in (ROOT / ".gitignore").read_text().splitlines()
    for where, path in outs.items():
        assert Path(path).parts[0] == "torch_runs", (where, path)
    tracked = subprocess.run(["git", "ls-files"], cwd=ROOT, capture_output=True, text=True)
    if tracked.returncode == 0:
        files = set(tracked.stdout.splitlines())
        assert "kernel_roofline.json" in files  # the JAX package's report
        assert not {p for p in outs.values() if p in files}


def test_entry_points_raise_without_cuda(monkeypatch, pair_files):
    from tpu3dm_torch.viz.trace import traced_ransac  # noqa: F401

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, tgt, _ = pair_files
    for argv in (["register", str(src), str(tgt)], ["trace", str(src), str(tgt)],
                 ["info", "--probe"], ["kernels", "--quick"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    for call in (lambda: kernelbench.run_kernel_benchmark(out_path=None),
                 lambda: benchmark.run_large_cloud_benchmark(2048),
                 lambda: benchmark.run_scaling_model()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# Subcommands end to end
# ---------------------------------------------------------------------------


def _stl(path):
    tris = np.array(
        [[[0, 0, 0], [1, 0, 0], [0, 1, 0]], [[1, 0, 0], [1, 1, 0], [0, 1, 0]],
         [[0, 0, 1], [1, 0.5, 1], [0, 1, 0.25]]],
        dtype="<f4",
    )
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(np.zeros(3, dtype="<f4").tobytes())
            f.write(t.tobytes())
            f.write(struct.pack("<H", 0))


@pytest.mark.parametrize("ascii_", [False, True])
def test_convert_bytes_equal_jax(tmp_path, ascii_):
    _stl(tmp_path / "m.stl")
    flag = ["--ascii"] if ascii_ else []
    assert jcli.main(["convert", str(tmp_path / "m.stl"), str(tmp_path / "j.ply"), *flag]) == 0
    assert cli.main(["convert", str(tmp_path / "m.stl"), str(tmp_path / "p.ply"), *flag,
                     "--device", "cpu"]) == 0
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("args", [["--fraction", "0.5", "--axis", "0"],
                                  ["--fraction", "0.3", "--axis", "2"],
                                  ["--bounds", "-5", "0", "-5", "5", "-5", "5"],
                                  ["--bounds", "1e6", "2e6", "1e6", "2e6", "1e6", "2e6"]])
def test_trim_bytes_equal_jax(tmp_path, args):
    j_write_ply(tmp_path / "c.ply", dental_arch_cloud(2000, seed=0))
    assert jcli.main(["trim", str(tmp_path / "c.ply"), str(tmp_path / "j.ply"), *args]) == 0
    assert cli.main(["trim", str(tmp_path / "c.ply"), str(tmp_path / "p.ply"), *args]) == 0
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


def _gate(T, T_true):
    M = np.asarray(T)[:3, :3] @ T_true[:3, :3].T
    rot = np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1)))
    return rot, np.abs(np.asarray(T)[:3, 3] - T_true[:3, 3]).max()


def test_register_in_gate_and_near_jax(pair_files, tmp_path, capsys):
    src, tgt, T_true = pair_files
    assert jcli.main(["register", str(src), str(tgt)]) == 0
    jout = json.loads(capsys.readouterr().out)
    assert cli.main(["register", str(src), str(tgt), "--device", "cpu",
                     "--out-ply", str(tmp_path / "reg.ply"),
                     "--out-html", str(tmp_path / "reg.html")]) == 0
    pout = json.loads(capsys.readouterr().out)
    T, Tj = np.asarray(pout["transformation"]), np.asarray(jout["transformation"])
    rot, dt = _gate(T, T_true)
    assert rot < 2.0 and dt < 0.1
    assert pout["icp"]["fitness"] > 0.8 and pout["icp"]["inlier_rmse"] < 0.1
    rot_j, dt_j = _gate(T, Tj)
    assert rot_j < 0.5 and dt_j < 0.02
    assert "canvas" in (tmp_path / "reg.html").read_text()
    from tpu3dm_torch.io.ply import read_ply

    assert "colors" in read_ply(tmp_path / "reg.ply")


def test_trace_writes_trace_html_and_animation(pair_files, tmp_path):
    src, tgt, _ = pair_files
    out, html, anim = tmp_path / "t.jsonl", tmp_path / "t.html", tmp_path / "a.html"
    assert cli.main(["trace", str(src), str(tgt), "--noise-ratio", "1.0",
                     "--update-interval", "128", "--out", str(out), "--out-html", str(html),
                     "--out-anim", str(anim), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows and rows[-1]["best_fitness"] > 0.15
    bests = [r["best_fitness"] for r in rows]
    assert all(b2 >= b1 for b1, b2 in zip(bests, bests[1:]))
    assert "canvas" in html.read_text()
    assert anim.read_text().count('"T"') == len(rows)


def test_register_batch_whole_windowed_and_resumed(pair_files, tmp_path):
    """A pair's bits follow its manifest position: the same pair three times
    gives three poses, each equal whole and in windows of 2 (one cloud
    capacity throughout, so the features are the same).  On a manifest of
    two distinct pairs, a checkpointed re-run restores every pair (records
    are keyed by the pair's paths), and every pair is gated."""
    src, tgt, T_true = pair_files
    s2, t2, T2 = make_benchmark_pair(4000, seed=2, sigma=0.005)
    j_write_ply(tmp_path / "s2.ply", s2)
    j_write_ply(tmp_path / "t2.ply", t2)
    same = tmp_path / "same.txt"
    same.write_text(f"{src} {tgt}\n" * 3)
    base = ["--ransac-iterations", "1024", "--device", "cpu"]

    def run(manifest, out, *extra):
        assert cli.main(["register-batch", str(manifest), *base, "--out", str(tmp_path / out),
                         *extra]) == 0
        return json.loads((tmp_path / out).read_text())

    whole, win = run(same, "whole.json"), run(same, "win.json", "--window", "2")
    assert [r["transformation"] for r in whole] == [r["transformation"] for r in win]
    assert whole[0]["transformation"] != whole[1]["transformation"]  # bits by position
    two = tmp_path / "two.json"
    two.write_text(json.dumps([[str(src), str(tgt)],
                               [str(tmp_path / "s2.ply"), str(tmp_path / "t2.ply")]]))
    ck = ["--window", "1", "--checkpoint-dir", str(tmp_path / "ck")]
    first, again = run(two, "first.json", *ck), run(two, "again.json", *ck)
    assert [r["transformation"] for r in again] == [r["transformation"] for r in first]
    assert [r["bucket_capacity"] for r in again] == [-1, -1]
    assert first[0]["transformation"] == whole[0]["transformation"]
    for r, T in zip(whole + first, (T_true, T_true, T_true, T_true, T2)):
        rot, dt = _gate(r["transformation"], T)
        assert rot < 2.0 and dt < 0.1


def test_multiway_batched(tmp_path):
    base = dental_arch_cloud(4000, seed=2)
    rng = np.random.default_rng(0)
    files = []
    for k in range(3):
        j_write_ply(tmp_path / f"c{k}.ply", base + rng.uniform(-0.05, 0.05, 3))
        files.append(str(tmp_path / f"c{k}.ply"))
    assert cli.main(["multiway", *files, "--batched", "--out", str(tmp_path / "p.json"),
                     "--device", "cpu"]) == 0
    poses = json.loads((tmp_path / "p.json").read_text())
    assert len(poses["poses"]) == 3 and len(poses["edges"]) == 3
    assert min(poses["edge_fitness"]) > 0.3


def test_info_kernels_crashtest_and_bench(pair_files, tmp_path, monkeypatch, capsys):
    assert cli.main(["info", "--probe", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["host_tier"] == "loaded" and info["float32_matmul_precision"] == "highest"
    assert info["matmul_allow_tf32"] is False and info["cudnn_allow_tf32"] is False
    assert info["host_voxel_100k_voxels"] > 0 and "first_dispatch_s" in info

    monkeypatch.setattr(kernelbench, "NN_SHAPES_QUICK", [(256, 256, 3)])
    monkeypatch.setattr(kernelbench, "DENSE_SHAPE", (64, 64, 33))
    monkeypatch.setattr(kernelbench, "SCORE_SHAPES_QUICK", [(64, 64)])
    roof = tmp_path / "roof.json"
    assert cli.main(["kernels", "--quick", "--out", str(roof), "--device", "cpu"]) == 0
    assert len(json.loads(roof.read_text())["cases"]) == 3

    from tpu3dm_torch.apps import crashtest

    seen = []
    monkeypatch.setattr(crashtest, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main(["crashtest", "--device", "cpu"]) == 0
    assert seen == [["--device", "cpu"]]

    src, tgt, _ = pair_files
    assert cli.main(["bench", "--source", str(src), "--target", str(tgt), "--test-iterations",
                     "1", "--ransac-iterations", "128", "--out-txt", str(tmp_path / "b.txt"),
                     "--out-json", str(tmp_path / "b.json"), "--device", "cpu"]) == 0
    report = json.loads((tmp_path / "b.json").read_text())
    assert report["config"]["backend"] == "cpu" and report["quality"]["ransac_fitness"] > 0.2
