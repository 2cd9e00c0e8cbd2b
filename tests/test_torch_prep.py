"""The port's ScanNet preprocessing against the JAX package on the CPU.

Synthetic raw scans (a binary mesh, its over-segmentation and aggregation
JSON, a label TSV) are written from numpy seeds; nothing of ScanNet is read.

- read_ply equals the JAX reader on binary little- and big-endian and ascii
  meshes (list properties, uniform and ragged) and on write_ply_points'
  ascii clouds.
- compute_vertex_normals (float64 sums with index_add_, on the given
  device) within 1e-6 of the JAX function, zero normals included; on the
  card the atomics add in another order, so 1e-6 is the contract there too.
- load_label_map (headed and headerless), collect_scene (with and without
  the subsample draw) and collect_scenes (a failing scene skipped) equal
  the JAX functions column for column but the normals (within 1e-6).
- virtual_scan's indices equal the JAX function's for modes -1 (a camera
  drawn from a seeded numpy generator), 2 and 4 on the JAX tests' scene,
  and none where no point is in view.
- scripts/preprocess_torch.py --device cpu writes what scripts/preprocess.py
  writes (normals within 1e-6), and its --visualize PLY.
"""

import json
import pathlib
import runpy
import struct

import numpy as np
import pytest
import torch

from pointnet2_scannet_tpu.data import scannet_prep as jprep
from pointnet2_scannet_tpu.utils import ply as jply
from pointnet2_scannet_tpu.utils.normals import compute_vertex_normals as jnormals
from pointnet2_scannet_tpu.utils.scene_util import virtual_scan as jvirtual_scan
from pointnet2_scannet_tpu_torch.data import scannet_prep, synthetic
from pointnet2_scannet_tpu_torch.utils import ply
from pointnet2_scannet_tpu_torch.utils.normals import compute_vertex_normals
from pointnet2_scannet_tpu_torch.utils.scene_util import virtual_scan
from tests.test_prep import write_binary_mesh

ROOT = pathlib.Path(__file__).resolve().parent.parent
NORMAL_TOL = 1e-6
SID = "scene0042_00"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(seed: int, n: int = 300):
    """Vertices, colours, and triangles with shared vertices, a degenerate
    one and an isolated vertex (n - 1 is in no face): zero normals too."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    faces = rng.integers(0, n - 1, (2 * n, 3))
    faces[0] = [5, 5, 6]
    return verts, colors, faces


def _write_mesh(path, verts, colors, faces, fmt: str) -> None:
    """A mesh PLY in fmt (binary_big_endian or ascii; faces may be ragged)."""
    head = (f"ply\nformat {fmt} 1.0\nelement vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(faces)}\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        for v, c in zip(verts, colors):
            f.write(struct.pack(">fffBBB", *v, *c) if fmt != "ascii"
                    else (" ".join(map(str, [*v.tolist(), *c.tolist()])) + "\n").encode())
        for face in faces:
            f.write(struct.pack(f">B{len(face)}i", len(face), *face) if fmt != "ascii"
                    else (" ".join(map(str, [len(face), *face])) + "\n").encode())


def _equal_ply(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], list):
            assert len(got[k]) == len(want[k]) and all(np.array_equal(a, b) for a, b in zip(got[k], want[k]))
        else:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("fmt", ["binary_little_endian", "binary_big_endian", "ascii", "ascii_ragged"])
def test_read_ply_equals_jax(tmp_path, fmt):
    verts, colors, faces = _mesh(1, n=40)
    path = tmp_path / "mesh.ply"
    if fmt == "binary_little_endian":
        write_binary_mesh(path, verts, colors, faces)
    else:
        faces = [list(f) for f in faces]
        if fmt == "ascii_ragged":
            faces[3] = faces[3] + [7]  # a quad among triangles: a list of arrays
        _write_mesh(path, verts, colors, faces, fmt.split("_")[0] if fmt.startswith("ascii") else fmt)
    got, want = ply.read_ply(path), jply.read_ply(path)
    _equal_ply(got, want)
    assert isinstance(got["face"], list) == (fmt == "ascii_ragged")
    np.testing.assert_array_equal(np.stack([got["vertex"][c] for c in "xyz"], 1), verts)


def test_write_ply_points_reads_back_as_jax_reads_it(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.uniform(size=(10, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (10, 3)).astype(np.uint8)
    ply.write_ply_points(tmp_path / "p.ply", pts, colors)
    jply.write_ply_points(tmp_path / "q.ply", pts, colors)
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "q.ply").read_bytes()
    _equal_ply(ply.read_ply(tmp_path / "p.ply"), jply.read_ply(tmp_path / "q.ply"))


def test_vertex_normals_match_jax():
    verts, _, faces = _mesh(3, n=2000)
    got = compute_vertex_normals(verts, faces, device="cpu")
    want = jnormals(verts, faces)
    assert got.dtype == np.float32 and got.shape == verts.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_TOL)
    zero = ~want.any(axis=1)  # vertices in no face (the last one among them)
    assert zero[-1] and (got[zero] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(got[~zero], axis=1), 1.0, atol=1e-6)


def _raw_scene(root, sid: str, seed: int, n: int = 300):
    """A fake ScanNet scan under root/scans/sid and a label TSV."""
    scan = root / "scans" / sid
    scan.mkdir(parents=True)
    verts, colors, faces = _mesh(seed, n)
    write_binary_mesh(scan / f"{sid}_vh_clean_2.ply", verts, colors, faces)
    (scan / f"{sid}_vh_clean_2.0.010000.segs.json").write_text(
        json.dumps({"segIndices": (np.arange(n) // 30).tolist()}))  # 10 segments of 30
    groups = [("chair_raw", [0, 1]), ("unknown_thing", [2]), ("floor_raw", [3, 4, 5]), ("weird", [6, 8])]
    (scan / f"{sid}.aggregation.json").write_text(json.dumps(
        {"segGroups": [{"id": i, "label": lab, "segments": segs} for i, (lab, segs) in enumerate(groups)]}))
    tsv = root / "labels.tsv"
    tsv.write_text("id\traw_category\tcount\tc3\tc4\tc5\tnyu40id\tnyu40class\n"
                   "1\tchair_raw\t1\t-\t-\t-\t5\tchair\n"
                   "2\tfloor_raw\t1\t-\t-\t-\t2\tfloor\n"
                   "3\tweird\t1\t-\t-\t-\t40\tsomething_unknown\n")
    return tsv


def _equal_but_normals(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    cols = [0, 1, 2, 3, 4, 5, 9, 10]
    np.testing.assert_array_equal(got[:, cols], want[:, cols])
    np.testing.assert_allclose(got[:, 6:9], want[:, 6:9], rtol=0, atol=NORMAL_TOL)


def test_label_map_equals_jax(tmp_path):
    tsv = _raw_scene(tmp_path, SID, 4)
    assert scannet_prep.load_label_map(tsv) == jprep.load_label_map(tsv)
    bare = tmp_path / "bare.tsv"  # headerless: the reference's columns 1 and 7
    bare.write_text("skipped first line\n1\tsofa_raw\t1\t-\t-\t-\t6\tsofa\n2\tshort\n3\tx\t1\t-\t-\t-\t9\tnope\n")
    got = scannet_prep.load_label_map(bare)
    assert got == jprep.load_label_map(bare) == {"sofa_raw": "sofa", "x": "otherprop"}


@pytest.mark.parametrize("max_points", [None, 150], ids=["all", "subsampled"])
def test_collect_scene_equals_jax(tmp_path, max_points):
    tsv = _raw_scene(tmp_path, SID, 5)
    label_map = jprep.load_label_map(tsv)
    kw = {} if max_points is None else {"max_points": max_points}
    got = scannet_prep.collect_scene(tmp_path / "scans", SID, label_map, device="cpu",
                                     rng=np.random.default_rng(8), **kw)
    want = jprep.collect_scene(tmp_path / "scans", SID, label_map, rng=np.random.default_rng(8), **kw)
    _equal_but_normals(got, want)
    assert len(got) == (max_points or 240)  # 8 of the 10 segments belong to a group
    assert set(got[:, 9].astype(int)) == {0, 1, 2, 3}


def test_collect_scenes_skips_errors_as_jax(tmp_path, capsys):
    tsv = _raw_scene(tmp_path, SID, 6)
    ids = [SID, "scene_missing_00"]
    got = scannet_prep.collect_scenes(tmp_path / "scans", ids, tsv, tmp_path / "port", device="cpu")
    want = jprep.collect_scenes(tmp_path / "scans", ids, tsv, tmp_path / "jax")
    assert got == want == [SID]
    assert capsys.readouterr().out.count("ERROR processing scene_missing_00") == 2
    _equal_but_normals(np.load(tmp_path / "port" / f"{SID}.npy"), np.load(tmp_path / "jax" / f"{SID}.npy"))
    with pytest.raises(FileNotFoundError):
        scannet_prep.collect_scenes(tmp_path / "scans", ids, tsv, tmp_path / "port", skip_errors=False,
                                    device="cpu")


@pytest.fixture(scope="module")
def scene_xyz():
    return synthetic.make_synthetic_scene(0, n_points=40_000)[:, :3]  # the JAX test's scene


@pytest.mark.parametrize("mode", [-1, 2, 4])
def test_virtual_scan_equals_jax(scene_xyz, mode):
    got = virtual_scan(scene_xyz, mode=mode, rng=np.random.default_rng(mode + 7), device="cpu")
    want = jvirtual_scan(scene_xyz, mode=mode, rng=np.random.default_rng(mode + 7))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert 100 <= len(want) < len(scene_xyz)


def test_virtual_scan_empty_out_of_view():
    xyz = np.random.default_rng(0).uniform(-0.1, 0.0, (500, 3)) - [50, 0, 0]
    got = virtual_scan(xyz, mode=4, device="cpu")
    assert got.shape == (0,) and got.dtype == torch.int64
    assert len(jvirtual_scan(xyz, mode=4)) == 0


def test_preprocess_torch_cli_on_the_cpu(tmp_path, capsys):
    tsv = _raw_scene(tmp_path, SID, 7)
    (tmp_path / "list.txt").write_text(f"{SID}\n")
    common = ["--scans_dir", str(tmp_path / "scans"), "--label_tsv", str(tsv), "--scene_list",
              str(tmp_path / "list.txt")]
    cli = runpy.run_path(str(ROOT / "scripts/preprocess_torch.py"), run_name="probe")
    done = cli["main"](cli["parse_args"]([*common, "--output_dir", str(tmp_path / "port"), "--device", "cpu"]))
    jcli = runpy.run_path(str(ROOT / "scripts/preprocess.py"), run_name="probe")
    jcli["main"](jcli["parse_args"]([*common, "--output_dir", str(tmp_path / "jax")]))
    assert done == [SID]
    assert "preprocessed 1/1 scenes" in capsys.readouterr().out
    _equal_but_normals(np.load(tmp_path / "port" / f"{SID}.npy"), np.load(tmp_path / "jax" / f"{SID}.npy"))
    cli["main"](cli["parse_args"](["--output_dir", str(tmp_path / "port"), "--visualize", SID]))
    jcli["main"](jcli["parse_args"](["--output_dir", str(tmp_path / "jax"), "--visualize", SID]))
    assert (tmp_path / "port" / f"{SID}_gt.ply").read_bytes() == (tmp_path / "jax" / f"{SID}_gt.ply").read_bytes()
    assert cli["parse_args"]([]).device == "cuda"
