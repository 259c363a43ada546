"""The CLI's GR triangle mode on the CPU (``--cube``, ``--obj``,
``--tri-intersector``): the layer's intersectors give the same frame, the
frame differs from the one without objects exactly where the layer hits,
and the printed split and counters are there."""

import numpy as np
import torch

from geodesic_raytracing_tpu_torch import cli

torch.set_num_threads(1)

ARGV = ["--metric", "schwarzschild", "--width", "16", "--height", "12",
        "--pitch", "-90", "--max-steps", "512", "--device", "cpu"]
CUBES = ["--cube", "-6", "0", "-3", "0", "--cube", "-6", "0", "3", "0"]


def _frame(tmp_path, name, extra):
    png = tmp_path / f"{name}.png"
    assert cli.main(ARGV + extra + ["--out", str(png)]) == 0
    return cli.read_png(png)


def test_cli_triangle_frame(tmp_path, capsys):
    """The two cubes of the CLI's example: dense and compact give the same
    frame.  Binned, at the CLI's budget of 64 swept triangles a chunk,
    overflows on it (its bins hold every triangle of both cubes' falls) and
    says so in its drop count, as the reference's does."""
    out = {name: _frame(tmp_path, name, CUBES + ["--tri-intersector", name])
           for name in ("dense", "compact", "binned")}
    out["none"] = _frame(tmp_path, "none", [])
    text = capsys.readouterr().out
    for name in ("dense", "compact", "binned"):
        assert f"intersector {name}" in text
    for stage in ("worldlines", "recorded march", "intersect", "composite"):
        assert f"{stage} " in text
    assert "dropped 0" in text.split("intersector compact")[1]
    binned = text.split("intersector binned")[1].split("\n")[0]
    assert float(binned.split("dropped ")[1]) > 0, binned
    np.testing.assert_array_equal(out["dense"], out["compact"])
    assert (out["binned"] != out["none"]).any()
    changed = (out["dense"] != out["none"]).any(-1)
    assert 0 < changed.mean() < 0.5


def test_cli_obj_mesh(tmp_path, capsys):
    """``--obj path,t,x,y,z,scale``: an .obj cube (6 quads, fanned into 12
    triangles) renders as the built-in cube of the same size does."""
    obj = tmp_path / "cube.obj"
    corners = [(x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1)]
    faces = [(1, 3, 4, 2), (5, 6, 8, 7), (1, 2, 6, 5), (3, 7, 8, 4),
             (1, 5, 7, 3), (2, 4, 8, 6)]
    obj.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in corners)
                   + "".join("f " + " ".join(map(str, f)) + "\n"
                             for f in faces))
    mesh = _frame(tmp_path, "mesh", ["--obj", f"{obj},-6,0,-3,0,1",
                                     "--tri-intersector", "compact"])
    cube = _frame(tmp_path, "cube", ["--cube", "-6", "0", "-3", "0",
                                     "--tri-intersector", "compact"])
    text = capsys.readouterr().out
    assert text.count("triangles: 1 objects") == 2
    none = _frame(tmp_path, "none", [])
    hit_mesh = (mesh != none).any(-1)
    hit_cube = (cube != none).any(-1)
    assert hit_mesh.any()
    np.testing.assert_array_equal(hit_mesh, hit_cube)
