"""COLMAP preprocessing wrapper (a copy of scripts/convert.py; reference
convert.py): feature extraction, exhaustive matching, mapping,
undistortion, and optional downscales. It runs COLMAP and ImageMagick as
the script does and touches no device.

  python -m langsplatv2_tpu_torch.preprocess.convert -s <location>
      [--no_gpu] [--skip_matching] [--resize] [--camera OPENCV]
      [--colmap_executable ...] [--magick_executable ...]
"""
import logging
import os
import shutil
import sys
from argparse import ArgumentParser


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)
    colmap_command = f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    magick_command = f'"{args.magick_executable}"' if args.magick_executable else "magick"
    use_gpu = 1 if not args.no_gpu else 0

    if shutil.which(colmap_command.strip('"')) is None:
        print(f"ERROR: colmap executable not found ({colmap_command}); "
              "install COLMAP or pass --colmap_executable")
        sys.exit(1)

    if not args.skip_matching:
        os.makedirs(args.source_path + "/distorted/sparse", exist_ok=True)
        feat_extracton_cmd = (
            f"{colmap_command} feature_extractor"
            f" --database_path {args.source_path}/distorted/database.db"
            f" --image_path {args.source_path}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}")
        if os.system(feat_extracton_cmd) != 0:
            logging.error("Feature extraction failed. Exiting.")
            sys.exit(1)

        feat_matching_cmd = (
            f"{colmap_command} exhaustive_matcher"
            f" --database_path {args.source_path}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        if os.system(feat_matching_cmd) != 0:
            logging.error("Feature matching failed. Exiting.")
            sys.exit(1)

        mapper_cmd = (
            f"{colmap_command} mapper"
            f" --database_path {args.source_path}/distorted/database.db"
            f" --image_path {args.source_path}/input"
            f" --output_path {args.source_path}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")
        if os.system(mapper_cmd) != 0:
            logging.error("Mapping failed. Exiting.")
            sys.exit(1)

    img_undist_cmd = (
        f"{colmap_command} image_undistorter"
        f" --image_path {args.source_path}/input"
        f" --input_path {args.source_path}/distorted/sparse/0"
        f" --output_path {args.source_path}"
        f" --output_type COLMAP")
    if os.system(img_undist_cmd) != 0:
        logging.error("Undistortion failed. Exiting.")
        sys.exit(1)

    files = os.listdir(args.source_path + "/sparse")
    os.makedirs(args.source_path + "/sparse/0", exist_ok=True)
    for file in files:
        if file == "0":
            continue
        shutil.move(os.path.join(args.source_path, "sparse", file),
                    os.path.join(args.source_path, "sparse", "0", file))

    if args.resize:
        print("Copying and resizing...")
        for factor, name in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
            os.makedirs(os.path.join(args.source_path, name), exist_ok=True)
        files = os.listdir(args.source_path + "/images")
        for file in files:
            src = os.path.join(args.source_path, "images", file)
            for factor, name in ((50, "images_2"), (25, "images_4"), (12.5, "images_8")):
                dst = os.path.join(args.source_path, name, file)
                shutil.copy2(src, dst)
                if os.system(f"{magick_command} mogrify -resize {factor}% {dst}") != 0:
                    logging.error(f"{factor}% resize failed. Exiting.")
                    sys.exit(1)
    print("Done.")


if __name__ == "__main__":
    main()
