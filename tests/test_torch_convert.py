"""``cli.convert`` against the root ``convert.py``, side by side.

The root script runs in a subprocess under this machine's Pillow (12.1.0);
the port's ``cli.convert.main`` runs in-process. Both get the same stand-in
colmap (``chip_smoke.write_standin``: a script that records its arguments
and writes what each COLMAP stage leaves) and, where asked, the same
stand-in ``magick``, on copies of the same captures
(``chip_smoke.write_captures``: the 8 committed 960x540 JPEG views; the
1080p JPEG and PNG and every PNG mode file). They must agree in:

* the commands the stand-ins recorded, in order, and the root script's list;
* the exit code and the logged error when each stage (and a resize) fails;
* the trees (every file's name) and ``sparse/0`` byte for byte;
* every pyramid JPEG byte for byte, every pyramid PNG in IHDR, PLTE, tRNS
  and decoded samples (the IDAT's deflate differs), and in what Pillow
  reads from it (mode, pixels, transparency).

Tolerance: 0 everywhere. The pyramid's digests, which ``chip_smoke.py``
section 36 checks on the card (no Pillow there), are written from the root
script's output by ``python -m tests.test_torch_convert --write-digests``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gaussian_transformer_tpu_torch import native  # noqa: E402
from gaussian_transformer_tpu_torch.cli import convert as cli_convert  # noqa: E402

STAGES = ("feature_extractor", "exhaustive_matcher", "mapper", "image_undistorter")
ERRORS = {"feature_extractor": "Feature extraction", "exhaustive_matcher": "Feature matching",
          "mapper": "Mapper", "image_undistorter": "Undistortion"}


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    return chip_smoke.write_captures(tmp_path_factory.mktemp("captures") / "src", seed=0)


def _copy(capture, dst: Path) -> Path:
    shutil.copytree(capture[0], dst)
    return dst


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("STANDIN_")}
    env.update(extra)
    return env


def run_root(sp: Path, bin_dir: Path, model, argv, env=None):
    """The root script on ``sp`` with a fresh stand-in colmap: (exit code,
    stderr, recorded calls)."""
    colmap = chip_smoke.write_standin(bin_dir, "colmap", model)
    proc = subprocess.run([sys.executable, str(ROOT / "convert.py"), "-s", str(sp), "--colmap_executable",
                           str(colmap)] + argv, env=env or _env(), capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stderr, chip_smoke.standin_calls(bin_dir)


def run_port(sp: Path, bin_dir: Path, model, argv, monkeypatch, caplog, env=None):
    """``cli.convert.main`` on the same arguments: (exit code, logged
    errors, recorded calls)."""
    colmap = chip_smoke.write_standin(bin_dir, "colmap", model)
    for k in [k for k in os.environ if k.startswith("STANDIN_")]:
        monkeypatch.delenv(k)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    caplog.clear()
    code = cli_convert.main(["-s", str(sp), "--colmap_executable", str(colmap)] + argv)
    errors = [f"{r.levelname}:{r.name}:{r.getMessage()}" for r in caplog.records if r.levelname == "ERROR"]
    return code, errors, chip_smoke.standin_calls(bin_dir)


def _normal(calls, sp: Path):
    return [[a.replace(str(sp), "<sp>") for a in c] for c in calls]


def _tree(sp: Path):
    return sorted(str(p.relative_to(sp)) for p in sp.rglob("*"))


def _root_errors(stderr: str):
    return [ln for ln in stderr.splitlines() if ln.startswith("ERROR:")]


def _same_pyramid(a: Path, b: Path) -> None:
    """Every images_N file: JPEGs byte for byte, PNGs by header and samples
    and by what Pillow reads from them."""
    for sub in ("images_2", "images_4", "images_8"):
        names = sorted(os.listdir(a / sub))
        assert names == sorted(os.listdir(b / sub))
        for name in names:
            fa, fb = a / sub / name, b / sub / name
            if name.lower().endswith(".png"):
                assert chip_smoke.png_header(fa.read_bytes()) == chip_smoke.png_header(fb.read_bytes()), fb
                assert chip_smoke.pyramid_digest(fa) == chip_smoke.pyramid_digest(fb), fb
                ia, ib = Image.open(fa), Image.open(fb)
                assert ia.mode == ib.mode and ia.info.get("transparency") == ib.info.get("transparency"), fb
                assert np.array_equal(np.asarray(ia), np.asarray(ib)), fb
            else:
                assert fa.read_bytes() == fb.read_bytes(), fb


def _no_magick() -> list:
    """Keeps the pyramid on Pillow / the port's writer where a magick is installed."""
    return [] if shutil.which("magick") is None else ["--magick_executable", "/nonexistent/magick"]


def test_colmap_capture_with_resize(captures, tmp_path, monkeypatch, caplog):
    """The whole chain on the 8 views: commands, trees, sparse/0, the JPEG pyramid."""
    capture, model = captures["colmap"]
    a, b = _copy(captures["colmap"], tmp_path / "root"), _copy(captures["colmap"], tmp_path / "port")
    ra = run_root(a, tmp_path / "bin_root", model, ["--resize"] + _no_magick())
    rb = run_port(b, tmp_path / "bin_port", model, ["--resize"] + _no_magick(), monkeypatch, caplog)
    assert ra[0] == rb[0] == 0, ra[1]
    assert ra[2] == chip_smoke.expected_calls(a) and rb[2] == chip_smoke.expected_calls(b)
    assert _tree(a) == _tree(b)
    assert sorted(os.listdir(b / "sparse" / "0")) == sorted(os.listdir(model))
    for f in os.listdir(model):
        assert (a / "sparse" / "0" / f).read_bytes() == (b / "sparse" / "0" / f).read_bytes() == (model / f).read_bytes()
    assert len(os.listdir(b / "images_8")) == 8
    _same_pyramid(a, b)


@pytest.mark.parametrize("flags", [["--skip_matching"], ["--no_gpu"], ["--camera", "PINHOLE"],
                                   ["--no_gpu", "--camera", "SIMPLE_RADIAL", "--skip_matching"]],
                         ids=lambda f: "_".join(x.strip("-") for x in f))
def test_flags_issue_the_same_commands(captures, tmp_path, monkeypatch, caplog, flags):
    capture, model = captures["colmap"]
    a, b = _copy(captures["colmap"], tmp_path / "root"), _copy(captures["colmap"], tmp_path / "port")
    ra = run_root(a, tmp_path / "bin_root", model, flags)
    rb = run_port(b, tmp_path / "bin_port", model, flags, monkeypatch, caplog)
    assert ra[0] == rb[0] == 0
    camera = flags[flags.index("--camera") + 1] if "--camera" in flags else "OPENCV"
    want = chip_smoke.expected_calls(b, camera=camera, gpu=0 if "--no_gpu" in flags else 1,
                                     skip_matching="--skip_matching" in flags)
    assert rb[2] == want and _normal(ra[2], a) == _normal(rb[2], b)
    assert _tree(a) == _tree(b) and not (b / "images_2").exists()


@pytest.mark.parametrize("stage,code", list(zip(STAGES, (3, 4, 5, 6))))
def test_a_failing_stage_exits_with_its_code(captures, tmp_path, monkeypatch, caplog, stage, code):
    capture, model = captures["colmap"]
    a, b = _copy(captures["colmap"], tmp_path / "root"), _copy(captures["colmap"], tmp_path / "port")
    fail = {"STANDIN_COLMAP_FAIL": f"{stage}:{code}"}
    ra = run_root(a, tmp_path / "bin_root", model, ["--resize"], env=_env(**fail))
    rb = run_port(b, tmp_path / "bin_port", model, ["--resize"], monkeypatch, caplog, env=fail)
    assert ra[0] == rb[0] == code
    assert _root_errors(ra[1]) == rb[1] == [f"ERROR:root:{ERRORS[stage]} failed with code {code}. Exiting."]
    assert _normal(ra[2], a) == _normal(rb[2], b)
    assert [c[1] for c in rb[2]] == list(STAGES[: STAGES.index(stage) + 1])
    assert _tree(a) == _tree(b) and not (b / "images_2").exists()


def test_resize_with_magick(captures, tmp_path, monkeypatch, caplog):
    """ImageMagick found: copy2 and one ``mogrify -resize N%`` a file and
    size, in the root script's order; a failing resize exits with its code."""
    capture, model = captures["colmap"]
    for fail in ("", "25%:9"):
        a, b = _copy(captures["colmap"], tmp_path / f"root{fail[:2]}"), _copy(captures["colmap"],
                                                                               tmp_path / f"port{fail[:2]}")
        bins = tmp_path / f"bin_root{fail[:2]}", tmp_path / f"bin_port{fail[:2]}"
        env = {"STANDIN_MAGICK_FAIL": fail} if fail else {}
        ma, mb = chip_smoke.write_standin(bins[0], "magick"), chip_smoke.write_standin(bins[1], "magick")
        ra = run_root(a, bins[0], model, ["--resize", "--magick_executable", str(ma)], env=_env(**env))
        rb = run_port(b, bins[1], model, ["--resize", "--magick_executable", str(mb)], monkeypatch, caplog, env=env)
        assert _normal(ra[2], a) == _normal(rb[2], b)
        magick = [c for c in rb[2] if c[0] == "magick"]
        if not fail:
            assert ra[0] == rb[0] == 0
            files = os.listdir(b / "images")
            assert magick == [["magick", "mogrify", "-resize", pct, str(b / sub / f)] for f in files
                              for sub, _, pct in cli_convert.PYRAMID]
            for sub, _, _ in cli_convert.PYRAMID:  # the stand-in leaves the copies as they are
                for f in files:
                    assert (b / sub / f).read_bytes() == (b / "images" / f).read_bytes()
                    assert os.stat(b / sub / f).st_mtime == os.stat(b / "images" / f).st_mtime  # copy2
        else:
            assert ra[0] == rb[0] == 9 and len(magick) == 2
            assert _root_errors(ra[1]) == rb[1] == ["ERROR:root:25% resize failed with code 9. Exiting."]
        assert _tree(a) == _tree(b)


def test_png_modes_resize_only(captures, tmp_path, monkeypatch, caplog):
    """``--skip_matching --resize`` on 1080p.jpg, 1080p.png and every PNG
    mode file ("1", "L" from 2/4/8 bits, "I;16", "RGB" from 8/16, "P" at
    1/2/4/8 bits with tRNS, "LA", "RGBA" from LA;16, RGBA 8/16; Adam7)."""
    a, b = _copy(captures["resize"], tmp_path / "root"), _copy(captures["resize"], tmp_path / "port")
    ra = run_root(a, tmp_path / "bin_root", None, ["--skip_matching", "--resize"] + _no_magick())
    rb = run_port(b, tmp_path / "bin_port", None, ["--skip_matching", "--resize"] + _no_magick(), monkeypatch,
                  caplog)
    assert ra[0] == rb[0] == 0
    assert rb[2] == chip_smoke.expected_calls(b, skip_matching=True)
    assert _tree(a) == _tree(b)
    modes = {Image.open(b / "images" / f).mode for f in os.listdir(b / "images")}
    assert modes == {"1", "L", "I;16", "RGB", "P", "LA", "RGBA"}
    _same_pyramid(a, b)


def test_output_does_not_depend_on_the_thread_count(captures, tmp_path, monkeypatch, caplog):
    """The pool takes the host's CPU count: 1 and 3 give the same files."""
    runs = {}
    for threads in (1, 3):
        sp = _copy(captures["resize"], tmp_path / f"t{threads}")
        monkeypatch.setattr(cli_convert.os, "cpu_count", lambda: threads)
        code = run_port(sp, tmp_path / f"bin{threads}", None, ["--skip_matching", "--resize"] + _no_magick(),
                        monkeypatch, caplog)[0]
        monkeypatch.undo()
        assert code == 0
        runs[threads] = {str(p.relative_to(sp)): p.read_bytes() for p in sp.rglob("images_*/*")}
    assert runs[1] == runs[3] and len(runs[1]) == 3 * len(os.listdir(captures["resize"][0] / "input"))


@pytest.mark.parametrize("fault", ["garbage", "truncated", "rgba_as_jpeg"])
def test_a_file_that_fails_stops_both_at_the_same_file(captures, tmp_path, fault):
    """Without ImageMagick, a file of images/ that cannot be read (garbage,
    a JPEG cut in half) or written (an RGBA PNG named .jpg: Pillow cannot
    write RGBA as JPEG) stops both scripts at that file: exit code 1 (the
    error, uncaught), every file before it in the folder's order written
    whole, none after it, and the same trees."""
    capture, model = captures["colmap"]
    names = os.listdir(capture / "input")
    bad = names[len(names) // 2]
    a, b = _copy(captures["colmap"], tmp_path / "root"), _copy(captures["colmap"], tmp_path / "port")
    for sp in (a, b):
        target = sp / "input" / bad
        if fault == "garbage":
            target.write_bytes(b"not an image\n" * 10)
        elif fault == "truncated":
            blob = target.read_bytes()
            target.write_bytes(blob[: len(blob) // 2])
        else:
            shutil.copyfile(chip_smoke.PNG_DIR / "modes" / "c6d8i0t0_33x17_50.png", target)
    ra = run_root(a, tmp_path / "bin_root", model, ["--resize"] + _no_magick())
    colmap = chip_smoke.write_standin(tmp_path / "bin_port", "colmap", model)
    rb = subprocess.run([sys.executable, "-m", "gaussian_transformer_tpu_torch.cli.convert", "-s", str(b),
                         "--colmap_executable", str(colmap), "--resize"] + _no_magick(), cwd=ROOT, env=_env(),
                        capture_output=True, text=True, timeout=600)
    assert ra[0] == rb.returncode == 1, (ra[1][-500:], rb.stderr[-500:])
    last = rb.stderr.strip().splitlines()[-1]
    assert last.startswith("OSError:") and (fault == "rgba_as_jpeg" or bad in last), last
    assert _normal(ra[2], a) == _normal(chip_smoke.standin_calls(tmp_path / "bin_port"), b)
    for sp in (a, b):
        order = os.listdir(sp / "images")
        k = order.index(bad)
        assert 0 < k < len(order) - 1, order
        assert {str(p.relative_to(sp)) for p in sp.glob("images_*/*")} == {
            f"{sub}/{f}" for sub, _, _ in cli_convert.PYRAMID for f in order[:k]}
    assert _tree(a) == _tree(b)
    _same_pyramid(a, b)


def test_an_unavailable_tier_raises_naming_why(captures, tmp_path, monkeypatch, caplog):
    """No fallback hides the tier: without it (and without ImageMagick)
    ``--resize`` raises with the build's reason; with a magick the tier is
    not needed."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_why", "no C++ compiler (g++ not found)")
    sp = _copy(captures["resize"], tmp_path / "port")
    with pytest.raises(native.CodecUnavailable, match=r"native IO tier .*no C\+\+ compiler \(g\+\+ not found\)"):
        run_port(sp, tmp_path / "bin", None, ["--skip_matching", "--resize"] + _no_magick(), monkeypatch, caplog)
    assert os.listdir(sp / "images_2") == []
    sp = _copy(captures["resize"], tmp_path / "magick")
    magick = chip_smoke.write_standin(tmp_path / "bin_magick", "magick")
    code = run_port(sp, tmp_path / "bin_magick", None, ["--skip_matching", "--resize", "--magick_executable",
                                                        str(magick)], monkeypatch, caplog)[0]
    assert code == 0 and len(os.listdir(sp / "images_2")) == len(os.listdir(sp / "images"))


def test_the_committed_digests_are_the_root_scripts(captures, tmp_path, monkeypatch, caplog):
    """``native/testdata/convert/digests.json`` (section 36's check on the
    card) holds the port's pyramid of both captures."""
    record = json.loads((chip_smoke.CONVERT_DIR / "digests.json").read_text())
    for name, extra in (("colmap", []), ("resize", ["--skip_matching"])):
        sp = _copy(captures[name], tmp_path / name)
        code = run_port(sp, tmp_path / f"bin_{name}", captures[name][1], extra + ["--resize"] + _no_magick(),
                        monkeypatch, caplog)[0]
        assert code == 0 and chip_smoke.pyramid_digests(sp) == record[name]


def pillow_digest(path: Path) -> str:
    """``chip_smoke.pyramid_digest`` of a file, with Pillow's decode in place
    of the port's: a PNG's samples as Pillow reads them (the modes Pillow
    writes hold the file's own samples: "1" as 0/1, "I;16" as 16 bits, "P"
    as indices), so the committed digests do not rest on the code they
    check."""
    blob = path.read_bytes()
    if not blob.startswith(b"\x89PNG"):
        return hashlib.sha256(blob).hexdigest()
    with Image.open(path) as im:
        arr = np.asarray(im)
    arr = (arr[..., None] if arr.ndim == 2 else arr).astype(">u2" if arr.dtype.itemsize == 2 else np.uint8)
    return hashlib.sha256(chip_smoke.png_header(blob) + arr.tobytes()).hexdigest()


def write_digests() -> None:
    """Run the root script (Pillow) on both captures and record its pyramid's
    digests, from Pillow's decode (``pillow_digest``), in
    ``native/testdata/convert/digests.json``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        caps = chip_smoke.write_captures(Path(tmp) / "src", seed=0)
        record = {}
        for name, extra in (("colmap", []), ("resize", ["--skip_matching"])):
            sp = _copy(caps[name], Path(tmp) / name)
            code, err, _ = run_root(sp, Path(tmp) / f"bin_{name}", caps[name][1],
                                    extra + ["--resize"] + _no_magick())
            assert code == 0, err
            record[name] = {f"{sub}/{p.name}": pillow_digest(p) for sub in ("images_2", "images_4", "images_8")
                            for p in sorted((sp / sub).iterdir())}
    chip_smoke.CONVERT_DIR.mkdir(parents=True, exist_ok=True)
    (chip_smoke.CONVERT_DIR / "digests.json").write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")
    print(f"wrote {sum(map(len, record.values()))} digests to {chip_smoke.CONVERT_DIR / 'digests.json'}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-digests"]:
        sys.exit("usage: python -m tests.test_torch_convert --write-digests")
    write_digests()
