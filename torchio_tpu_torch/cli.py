"""``torchio-tpu-torch`` command-line interface.

Counterpart of ``torchio_tpu/cli.py``: the subcommands info, plot,
animate, convert, transform and cache, with the same arguments and
messages. Run it as ``python -m torchio_tpu_torch.cli`` or
``torchio-tpu-torch``. Images load on the package's default device (the
card unless a caller asks for the CPU), and ``transform`` runs there;
``info --load`` reduces the data there and prints three host scalars.
"""

from __future__ import annotations

import argparse
import ast
import shutil
import sys
from pathlib import Path


def _load_image(path: str, label: bool = False):
    from .data.image import LabelMap, ScalarImage

    cls = LabelMap if label else ScalarImage
    return cls(path)


def cmd_info(args: argparse.Namespace) -> int:
    from .core.dtypes import dtype_name

    image = _load_image(args.input, args.label)
    print(f"path:        {image.path}")
    print(f"shape:       {image.shape}")
    print(f"spacing:     {tuple(round(s, 4) for s in image.spacing)}")
    print(f"origin:      {tuple(round(o, 4) for o in image.origin)}")
    print(f"orientation: {''.join(image.orientation)}+")
    print(f"dtype:       {dtype_name(image.dtype)}")
    if args.load:
        import torch

        data = image.data
        stats = [data.min().double(), data.mean(dtype=torch.float64), data.max().double()]
        low, avg, high = torch.stack(stats).tolist()
        print(f"min/mean/max: {low:.4g} / {avg:.4g} / {high:.4g}")
    return 0


def cmd_plot(args: argparse.Namespace) -> int:
    from .visualization import plot_image

    image = _load_image(args.input, args.label)
    plot_image(image, output_path=args.output, show=args.output is None)
    if args.output:
        print(f"saved {args.output}")
    return 0


def cmd_animate(args: argparse.Namespace) -> int:
    from .visualization import make_gif, make_video

    image = _load_image(args.input, args.label)
    out = Path(args.output)
    if out.suffix.lower() == ".gif":
        make_gif(image, out, axis=args.axis)
    else:
        make_video(image, out, axis=args.axis)
    print(f"saved {out}")
    return 0


def cmd_convert(args: argparse.Namespace) -> int:
    image = _load_image(args.input, args.label)
    image.save(args.output)
    print(f"saved {args.output}")
    return 0


def cmd_transform(args: argparse.Namespace) -> int:
    from . import random as tio_random
    from .transforms.transform import _TRANSFORM_REGISTRY

    if args.name not in _TRANSFORM_REGISTRY:
        known = sorted(n for n in _TRANSFORM_REGISTRY if not n.startswith("_"))
        print(f"Unknown transform {args.name!r}. Known: {', '.join(known)}")
        return 2
    kwargs = {}
    for pair in args.kwargs:
        key, _, value = pair.partition("=")
        try:
            kwargs[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            kwargs[key] = value
    if args.seed is not None:
        tio_random.seed(args.seed)
    transform = _TRANSFORM_REGISTRY[args.name](**kwargs)
    image = _load_image(args.input, args.label)
    result = transform(image)
    result.save(args.output)
    print(f"saved {args.output}")
    return 0


def cmd_cache(args: argparse.Namespace) -> int:
    from .utils.download import get_cache_dir

    cache = get_cache_dir()
    if args.action == "dir":
        print(cache)
    elif args.action == "clean":
        if cache.is_dir():
            shutil.rmtree(cache)
            print(f"removed {cache}")
        else:
            print(f"nothing to remove at {cache}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="torchio-tpu-torch",
        description="3D medical image preprocessing toolkit (PyTorch / CUDA)",
    )
    from . import __version__

    parser.add_argument(
        "--version", action="version", version=f"torchio-tpu-torch {__version__}"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="print image metadata")
    p.add_argument("input")
    p.add_argument("--label", action="store_true")
    p.add_argument("--load", action="store_true", help="also load data statistics")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("plot", help="save or show a 3-plane plot")
    p.add_argument("input")
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--label", action="store_true")
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser("animate", help="write a slice-sweep gif/mp4")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--axis", type=int, default=2)
    p.add_argument("--label", action="store_true")
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser("convert", help="convert between image formats")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--label", action="store_true")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("transform", help="apply any registered transform")
    p.add_argument("name", help="transform class name, e.g. Affine")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("kwargs", nargs="*", help="key=value constructor args")
    p.add_argument("--label", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.set_defaults(fn=cmd_transform)

    p = sub.add_parser("cache", help="manage the dataset cache")
    p.add_argument("action", choices=["dir", "clean"])
    p.set_defaults(fn=cmd_cache)

    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
