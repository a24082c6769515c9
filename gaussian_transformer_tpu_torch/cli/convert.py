"""The COLMAP conversion driver (port of the root ``convert.py``).

Runs the ``colmap`` binary's ``feature_extractor``, ``exhaustive_matcher``,
``mapper`` and ``image_undistorter`` on ``<source_path>/input`` with the
root script's flags and the same shell commands, character for character,
moves ``sparse/*`` into ``sparse/0``, and with ``--resize`` writes the
``images_2``, ``images_4`` and ``images_8`` pyramid (50%, 25%, 12.5%). A
stage that fails logs the root script's error and ends the run with its
exit code, which ``main`` returns.

The pyramid: where ImageMagick is found (``shutil.which``), each file is
copied and shrunk by ``magick mogrify -resize N%``, as in the root script.
Otherwise each file is read, resized and written as the root script's
``resize_with_pil`` does with Pillow (``Image.open(src).resize((max(1,
round(w * p)), max(1, round(h * p)))).save(dst)``), but with the port's own
code and no Pillow (``utils/imagefile.py``): the native IO tier decodes in
the mode Pillow opens the file in, ``utils/resample.py`` resizes as
Pillow's ``resize`` does in that mode, and a JPEG is written by the tier's
encoder byte for byte as Pillow writes it, a PNG by ``utils/png.py`` with
Pillow's header, palette, tRNS and samples. Files are encoded on a thread
pool and written in the root script's order, so the output does not depend
on the thread count, and a file that cannot be read or written stops the
run where the root script stops: what came before it is written, its
error raised (exit code 1 from the command line), nothing after it
written. Without ImageMagick the tier is required: when it cannot be
built, ``--resize`` raises ``native.CodecUnavailable`` naming the reason,
and nothing else is tried.

The driver touches no tensor, so it takes no ``--device``, like the root
script.

    python -m gaussian_transformer_tpu_torch.cli.convert -s <dir> [--resize] [--skip_matching] [--no_gpu]
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser
from concurrent.futures import ThreadPoolExecutor

from gaussian_transformer_tpu_torch import native
from gaussian_transformer_tpu_torch.utils import imagefile

PYRAMID = (("images_2", 0.5, "50%"), ("images_4", 0.25, "25%"), ("images_8", 0.125, "12.5%"))


def run(cmd: str) -> int:
    print("+", cmd, flush=True)
    return subprocess.call(cmd, shell=True)


def shrink(src: str, dsts):
    """The pyramid of one file as the root script's ``resize_with_pil`` calls
    make it, one (dst, percent) after another, encoded but not written:
    ([(dst, bytes)], the error that stopped it, or None)."""
    out = []
    try:
        img = imagefile.open_image(src)
        w, h = img.size
        for dst, pct in dsts:
            small = imagefile.resize_image(img, (max(1, round(w * pct)), max(1, round(h * pct))))
            out.append((dst, imagefile.encode_image(small, dst)))
    except Exception as e:  # raised in the file's turn by resize_folder
        return out, e
    return out, None


def resize_folder(sp: str, files) -> None:
    """The pyramid of ``<sp>/images/<file>`` without ImageMagick. The files
    are encoded on a pool of the host's CPUs and written in the order of
    ``files``, as the root script writes them: at the first file that
    fails, what the root script wrote before its error is written, that
    error is raised, and no later file is written."""
    if not native.available():  # also loads the tier once, before the pool's threads call it
        raise native.CodecUnavailable(
            "writing the images_2/4/8 pyramid without ImageMagick needs the native IO tier "
            f"(gaussian_transformer_tpu_torch/native): {native.unavailable_reason()}")
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        jobs = [pool.submit(shrink, os.path.join(sp, "images", file),
                            [(os.path.join(sp, sub, file), pct) for sub, pct, _ in PYRAMID]) for file in files]
        try:
            for job in jobs:
                done, error = job.result()
                for dst, data in done:
                    with open(dst, "wb") as f:
                        f.write(data)
                if error is not None:
                    raise error
        finally:
            for job in jobs:
                job.cancel()


def main(argv=None) -> int:
    """Run the conversion on ``argv`` (default: ``sys.argv[1:]``); returns
    the exit code (0, or the failed stage's)."""
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    magick = f'"{args.magick_executable}"' if args.magick_executable else "magick"
    use_gpu = 0 if args.no_gpu else 1
    sp = args.source_path

    if not args.skip_matching:
        os.makedirs(sp + "/distorted/sparse", exist_ok=True)

        code = run(
            f"{colmap} feature_extractor --database_path {sp}/distorted/database.db "
            f"--image_path {sp}/input --ImageReader.single_camera 1 "
            f"--ImageReader.camera_model {args.camera} --SiftExtraction.use_gpu {use_gpu}"
        )
        if code != 0:
            logging.error(f"Feature extraction failed with code {code}. Exiting.")
            return code

        code = run(
            f"{colmap} exhaustive_matcher --database_path {sp}/distorted/database.db "
            f"--SiftMatching.use_gpu {use_gpu}"
        )
        if code != 0:
            logging.error(f"Feature matching failed with code {code}. Exiting.")
            return code

        code = run(
            f"{colmap} mapper --database_path {sp}/distorted/database.db "
            f"--image_path {sp}/input --output_path {sp}/distorted/sparse "
            f"--Mapper.ba_global_function_tolerance=0.000001"
        )
        if code != 0:
            logging.error(f"Mapper failed with code {code}. Exiting.")
            return code

    code = run(
        f"{colmap} image_undistorter --image_path {sp}/input "
        f"--input_path {sp}/distorted/sparse/0 --output_path {sp} --output_type COLMAP"
    )
    if code != 0:
        logging.error(f"Undistortion failed with code {code}. Exiting.")
        return code

    os.makedirs(sp + "/sparse/0", exist_ok=True)
    for file in os.listdir(sp + "/sparse"):
        if file == "0":
            continue
        shutil.move(os.path.join(sp, "sparse", file), os.path.join(sp, "sparse", "0", file))

    if args.resize:
        print("Copying and resizing...", flush=True)
        have_magick = shutil.which(args.magick_executable or "magick") is not None
        for sub, _, _ in PYRAMID:
            os.makedirs(os.path.join(sp, sub), exist_ok=True)
        files = os.listdir(sp + "/images")
        if have_magick:
            for file in files:
                src = os.path.join(sp, "images", file)
                for sub, _, pct_s in PYRAMID:
                    dst = os.path.join(sp, sub, file)
                    shutil.copy2(src, dst)
                    code = run(f"{magick} mogrify -resize {pct_s} {dst}")
                    if code != 0:
                        logging.error(f"{pct_s} resize failed with code {code}. Exiting.")
                        return code
        else:
            resize_folder(sp, files)

    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
