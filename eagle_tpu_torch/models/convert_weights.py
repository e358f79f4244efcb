"""Convert the reference's torch checkpoints to ``.msgpack`` parameter trees
(counterpart of the JAX package's ``scripts/convert_weights.py``):

    python -m eagle_tpu_torch.models.convert_weights --kind hrnet  --src keypoints_main.pth --out weights/hrnet.msgpack
    python -m eagle_tpu_torch.models.convert_weights --kind yolov8 --src detector_large_hd.pt --out weights/yolov8l.msgpack

Both packages read the result (the JAX package with a template,
``load_params(path, template=...)``).
"""

from argparse import ArgumentParser

from eagle_tpu_torch.models.checkpoint import convert_and_save


def main(argv=None) -> None:
    p = ArgumentParser(description="torch checkpoint -> .msgpack parameter tree")
    p.add_argument("--kind", choices=["hrnet", "yolov8"], required=True)
    p.add_argument("--src", required=True, help="torch checkpoint path")
    p.add_argument("--out", required=True, help="output .msgpack path")
    args = p.parse_args(argv)
    print(convert_and_save(args.src, args.out, args.kind))


if __name__ == "__main__":
    main()
