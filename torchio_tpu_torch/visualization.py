"""Matplotlib 3-plane visualization, subject grids, GIF/video export.

Counterpart of ``torchio_tpu/visualization.py``: three-plane slice plots
in radiological convention, label colormaps, subject grids with a shared
crosshair, GIF via Pillow, MP4 via ffmpeg. The figures and frames are
the JAX package's, pixel for pixel.

The data stays on its device. The RAS+ reorientation is a permutation of
the image's axes (a view) and flips applied to the drawn planes only;
the statistics a figure needs (its display window's percentiles, a label
map's largest label, a sweep's range) are reduced on the device and read
as a few scalars. Only what a host library draws crosses to the host,
once: the three planes of a figure, or a sweep's frames as uint8.
:data:`HOST_COPIES` counts those copies and their bytes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from .core.orientation import (
    apply_orientation,
    axcodes2ornt,
    inv_ornt_aff,
    io_orientation,
    ornt_transform,
)
from .data.image import Image, LabelMap
from .data.subject import Subject
from .external.imports import get_matplotlib, get_pil

#: Copies from the device to the host made by this module: their number
#: and their bytes since import (zero them to count one figure).
HOST_COPIES: dict[str, int] = {"copies": 0, "bytes": 0}


def _to_host(tensor: torch.Tensor) -> np.ndarray:
    """One copy to the host, counted in :data:`HOST_COPIES`."""
    HOST_COPIES["copies"] += 1
    HOST_COPIES["bytes"] += tensor.numel() * tensor.element_size()
    return tensor.detach().cpu().numpy()


def _get_matplotlib():
    matplotlib = get_matplotlib()
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _ras_ornt(image: Image) -> np.ndarray:
    return ornt_transform(io_orientation(image.affine.data), axcodes2ornt(("R", "A", "S")))


def _ras_geometry(image: Image) -> tuple[tuple[int, int, int], np.ndarray]:
    """(spatial shape in RAS+, matching affine), from the header alone."""
    ornt = _ras_ornt(image)
    shape = image.spatial_shape
    affine = image.affine.data @ inv_ornt_aff(ornt, shape)
    shape_ras = tuple(int(shape[int(p)]) for p in np.argsort(ornt[:, 0]))
    return shape_ras, affine


class _RasView:
    """An image's data seen in RAS+ without moving it: what
    ``apply_orientation`` would make of it, as a permuted view whose
    flipped axes are flipped only in the planes taken from it."""

    def __init__(self, image: Image) -> None:
        ornt = _ras_ornt(image)
        perm = [int(p) for p in np.argsort(ornt[:, 0])]  # RAS axis r <- data axis perm[r]
        self.source = image.data
        self.data = self.source.permute(0, *(p + 1 for p in perm))
        self.flipped = [bool(ornt[p, 1] == -1) for p in perm]
        self.shape_ras, self.affine = _ras_geometry(image)

    def plane(self, channel: int, axis: int, index: int) -> torch.Tensor:
        """``data_ras[channel]`` at ``index`` along RAS ``axis`` (2-D)."""
        if self.flipped[axis]:
            index = self.shape_ras[axis] - 1 - index
        plane = self.data[channel].select(axis, index)
        rest = [r for r in range(3) if r != axis]
        dims = [d for d, r in enumerate(rest) if self.flipped[r]]
        return torch.flip(plane, dims) if dims else plane

    def planes(self, indices, channel: int) -> list[np.ndarray]:
        """The sagittal, coronal and axial planes through ``indices`` (RAS
        voxel), in one copy to the host."""
        planes = [self.plane(channel, axis, int(i)) for axis, i in enumerate(indices)]
        flat = _to_host(torch.cat([p.reshape(-1) for p in planes]))
        out, start = [], 0
        for p in planes:
            out.append(flat[start : start + p.numel()].reshape(tuple(p.shape)))
            start += p.numel()
        return out


def _scalars(*values: torch.Tensor) -> np.ndarray:
    """Device scalars (0-d tensors of one dtype) in one copy to the host."""
    return _to_host(torch.stack(values))


def _percentiles(data: torch.Tensor, percentiles) -> np.ndarray:
    """``np.percentile(data, percentiles)`` (linear) of every voxel, from
    the order statistics it needs: one sort on the device, the two
    neighbours of each rank and the largest value copied to the host, the
    interpolation done there with numpy's own arithmetic and dtypes."""
    flat = data.reshape(-1)
    n = flat.numel()
    q = np.true_divide(np.asarray(percentiles, np.float64), 100)
    virtual = (n - 1) * q
    previous = np.floor(virtual)
    nxt = previous + 1
    above = virtual >= n - 1
    previous[above], nxt[above] = -1, -1
    below = virtual < 0
    previous[below], nxt[below] = 0, 0
    gamma = virtual - previous
    ranks = np.concatenate([previous, nxt, [-1]]).astype(np.int64) % n
    ordered = torch.sort(flat).values  # NaNs last, as numpy's partition puts them
    picked = _to_host(ordered[torch.as_tensor(ranks, device=flat.device)])
    m = len(q)
    a, b = picked[:m], picked[m : 2 * m]
    diff = np.subtract(b, a)
    result = np.asanyarray(np.add(a, diff * gamma))
    np.subtract(b, diff * (1 - gamma), out=result, where=gamma >= 0.5, casting="unsafe")
    if flat.is_floating_point() and np.isnan(picked[-1]):
        result[:] = np.nan
    return result


def _sweep_uint8(data: torch.Tensor) -> np.ndarray:
    """A (I, J, K) volume scaled to uint8 over its own range, as the JAX
    package's frames compute it in numpy, on the device; one copy of the
    bytes to the host."""
    if not data.is_floating_point():
        data = data.to(torch.float64)  # numpy's integer - float is float64
    lo, hi = (float(v) for v in _scalars(*torch.aminmax(data)))
    scale = 255.0 / (hi - lo) if hi > lo else 1.0
    return _to_host(((data - lo) * scale).to(torch.uint8))


def _coordinates_to_indices(coordinates, affine_ras, shape_ras):
    """World-mm point -> clipped RAS voxel indices (reference
    ``visualization.py:514-531``). ``None`` components keep the
    mid-volume slice — substituted with the mid-volume WORLD coordinate
    before inverting, so oblique affines (whose inverse mixes axes)
    still map the specified components to the right voxels."""
    # s // 2 (not (s-1)/2): must match the index the None component
    # actually renders, else oblique inversions land half a voxel off
    mid_voxel = np.array([float(s // 2) for s in shape_ras] + [1.0])
    mid_world = affine_ras @ mid_voxel
    filled = [
        mid_world[a] if c is None else float(c)
        for a, c in enumerate(coordinates)
    ]
    voxel = np.linalg.inv(affine_ras) @ np.array([*filled, 1.0])
    return tuple(
        s // 2 if c is None else int(np.clip(round(v), 0, s - 1))
        for c, v, s in zip(coordinates, voxel[:3], shape_ras)
    )


def _label_cmap(num_labels: int):
    plt = _get_matplotlib()
    from matplotlib.colors import ListedColormap

    # colorcet's glasbey palette gives maximally-distinct label colors
    # (what the reference uses); tab10/20 is the fallback.
    try:  # pragma: no cover - colorcet not in this image
        import colorcet

        palette = colorcet.glasbey[: max(num_labels, 1)]
        colors = [(0, 0, 0, 0)] + list(palette)
        return ListedColormap(colors)
    except ImportError:
        base = plt.get_cmap("tab10" if num_labels <= 10 else "tab20")
        colors = [(0, 0, 0, 0)] + [
            base(i % base.N) for i in range(max(num_labels, 1))
        ]
        return ListedColormap(colors)


def _colorize_labels(plane: np.ndarray, color_map: dict) -> np.ndarray:
    """Label slice -> RGB uint8 via one LUT gather (reference colorizes
    with a per-label boolean loop, ``visualization.py:252-264``; a LUT
    index is equivalent and O(pixels)). Labels absent from the map
    render black."""
    labels = np.rint(plane).astype(np.int64)
    # LUT sized by the color map alone (not the plane's max value): a
    # corrupt volume carrying a huge intensity must not trigger a
    # multi-GB allocation; labels beyond the map clip and render black
    # (index 0 stays black unless the map colors it)
    size = max((int(k) for k in color_map if int(k) >= 0), default=0) + 1
    lut = np.zeros((size + 1, 3), dtype=np.uint8)  # last row = out-of-map
    for label, rgb in color_map.items():
        if 0 <= int(label) < size:
            lut[int(label)] = rgb
    mapped = np.where((labels >= 0) & (labels < size), labels, size)
    return lut[mapped]


#: (display-x data axis, display-y data axis) per plane after the
#: np.rot90 used for display; data axes are RAS indices 0=R, 1=A, 2=S.
_PLANE_AXES = {"Sagittal": (1, 2), "Coronal": (0, 2), "Axial": (0, 1)}
_AXIS_LABELS = {0: ("L", "R"), 1: ("P", "A"), 2: ("I", "S")}


def _apply_ticks(ax, plane_name, shape_ras, affine_ras, *, units, flip_x):
    """Anatomical axis labels + voxel or mm tick labels.

    After RAS reorientation the affine is axis-aligned up to obliquity;
    mm labels use the dominant world coordinate per axis (exact for
    non-oblique volumes, the reference's behavior).
    """
    ax_x, ax_y = _PLANE_AXES[plane_name]
    n_x, n_y = shape_ras[ax_x], shape_ras[ax_y]

    def world(axis, idx):
        voxel = [0.0, 0.0, 0.0]
        voxel[axis] = idx
        return float(
            affine_ras[axis, :3] @ np.asarray(voxel) + affine_ras[axis, 3]
        )

    def tick_values(n):
        step = max(1, int(np.ceil(n / 5 / 10.0)) * 10) if n > 20 else max(1, n // 4)
        return list(range(0, n, step))

    xs = tick_values(n_x)
    ys = tick_values(n_y)
    disp_x = [(n_x - 1 - v) if flip_x else v for v in xs]
    disp_y = [n_y - 1 - v for v in ys]  # rot90 puts axis-y upward
    if units == "mm":
        x_labels = [f"{world(ax_x, v):.0f}" for v in xs]
        y_labels = [f"{world(ax_y, v):.0f}" for v in ys]
        unit_suffix = " (mm)"
    else:
        x_labels = [str(v) for v in xs]
        y_labels = [str(v) for v in ys]
        unit_suffix = " (voxel)"
    ax.set_xticks(disp_x, x_labels, fontsize=7)
    ax.set_yticks(disp_y, y_labels, fontsize=7)
    neg_x, pos_x = _AXIS_LABELS[ax_x]
    neg_y, pos_y = _AXIS_LABELS[ax_y]
    if flip_x:
        neg_x, pos_x = pos_x, neg_x
    ax.set_xlabel(f"{neg_x} → {pos_x}{unit_suffix}", fontsize=8)
    ax.set_ylabel(f"{neg_y} → {pos_y}{unit_suffix}", fontsize=8)


def _draw_crosshair(ax, plane_name, shape_ras, indices, *, flip_x, color="lime"):
    """Crosshair lines at the (i, j, k) RAS voxel on one plane."""
    ax_x, ax_y = _PLANE_AXES[plane_name]
    n_x, n_y = shape_ras[ax_x], shape_ras[ax_y]
    x = indices[ax_x]
    y = indices[ax_y]
    disp_x = (n_x - 1 - x) if flip_x else x
    disp_y = n_y - 1 - y
    ax.axvline(disp_x, color=color, lw=0.8, alpha=0.8)
    ax.axhline(disp_y, color=color, lw=0.8, alpha=0.8)


#: Intersection-line colors keyed by the RAS axis the located plane
#: slices (0 = sagittal, 1 = coronal, 2 = axial); the 3D Slicer
#: convention the reference adopted (``visualization.py:68-77``).
_SLICE_AXIS_COLOR = {0: "#42A5F5", 1: "#8FE561", 2: "#FF8372"}


def _draw_intersections(ax, plane_name, shape_ras, indices, *, flip_x):
    """Linked slice-intersection lines on one plane, each colored by
    the view it locates (reference ``visualization.py:799-831``): the
    vertical line marks the plane slicing this pane's x data axis, the
    horizontal one the plane slicing its y data axis."""
    ax_x, ax_y = _PLANE_AXES[plane_name]
    n_x, n_y = shape_ras[ax_x], shape_ras[ax_y]
    disp_x = (n_x - 1 - indices[ax_x]) if flip_x else indices[ax_x]
    disp_y = n_y - 1 - indices[ax_y]
    ax.axvline(disp_x, color=_SLICE_AXIS_COLOR[ax_x], lw=0.8, alpha=0.8)
    ax.axhline(disp_y, color=_SLICE_AXIS_COLOR[ax_y], lw=0.8, alpha=0.8)


def plot_image(
    image: Image,
    axes=None,
    *,
    indices=None,
    coordinates=None,
    channel: int = 0,
    cmap: str | dict | None = None,
    output_path: str | Path | None = None,
    show: bool = True,
    title: str | None = None,
    radiological: bool = True,
    units: str | None = "mm",
    voxels: bool = False,
    crosshair: bool = False,
    intersections: bool = False,
    percentiles: tuple[float, float] | None = (0.5, 99.5),
    figsize: tuple[float, float] | None = None,
    savefig_kwargs: dict[str, Any] | None = None,
    show_titles: bool = True,
    **imshow_kwargs: Any,
) -> Any:
    """Plot mid-volume sagittal/coronal/axial slices.

    Args:
        indices: (i, j, k) RAS voxel to slice at (default: mid-volume).
        coordinates: world-mm (x, y, z) point to slice at (mutually
            exclusive with ``indices``; ``None`` components keep the
            mid-volume slice).
        channel: which image channel to display.
        cmap: a matplotlib colormap name, or a ``{label: (r, g, b)}``
            dict that colorizes a label map to RGB. When omitted, a label
            image carrying a ``color_map`` dict (e.g.
            :class:`datasets.FPG`'s GIF palette) colorizes itself.
        radiological: show the patient's left on the image right
            (coronal/axial panes flipped; ``False`` = neurological).
        units: tick labels in ``"mm"`` (world coordinates), ``"voxel"``,
            or ``None`` for no ticks. Axes are labeled with anatomical
            directions (e.g. ``P → A (mm)``).
        voxels: shorthand for ``units="voxel"``.
        crosshair: draw single-color intersection lines at ``indices``.
        intersections: draw LINKED intersection lines, each colored by
            the view whose slice position it marks (3D Slicer's palette).
        percentiles: display window for scalar images (robust to
            outliers, the nnU-Net (0.5, 99.5) convention); ``None``
            uses the full range.
        savefig_kwargs: extra keyword arguments for ``fig.savefig``.
        imshow_kwargs: forwarded to ``ax.imshow``.
    """
    plt = _get_matplotlib()
    is_label = isinstance(image, LabelMap)
    if voxels:
        units = "voxel"
    view = _RasView(image)
    shape_ras, affine_ras = view.shape_ras, view.affine
    if coordinates is not None:
        if indices is not None:
            raise ValueError("Pass indices OR coordinates, not both")
        indices = _coordinates_to_indices(coordinates, affine_ras, shape_ras)
    if indices is None:
        indices = tuple(s // 2 for s in shape_ras)
    sag, cor, axi = view.planes(indices, channel)
    if axes is None:
        fig, axes = plt.subplots(1, 3, figsize=figsize or (10, 3.4))
    else:
        fig = axes[0].figure
    names = ("Sagittal", "Coronal", "Axial")
    spacing = np.linalg.norm(affine_ras[:3, :3], axis=0)
    aspects = (
        spacing[2] / spacing[1],
        spacing[2] / spacing[0],
        spacing[1] / spacing[0],
    )
    color_map = None
    if isinstance(cmap, dict):
        color_map = cmap
    elif cmap is None and isinstance(getattr(image, "color_map", None), dict):
        # e.g. datasets.FPG carries the GIF parcellation palette
        color_map = image.color_map
    if color_map is not None:
        sag, cor, axi = (_colorize_labels(p, color_map) for p in (sag, cor, axi))
        kwargs = {"interpolation": "none"}
    elif is_label:
        num = int(_scalars(view.source.max())[0])
        kwargs = {
            "cmap": _label_cmap(num),
            "vmin": 0,
            "vmax": num,
            "interpolation": "none",
        }
    else:
        kwargs = {"cmap": cmap or "gray"}
        if percentiles is not None:
            lo, hi = _percentiles(view.source, percentiles)
            if hi > lo:
                kwargs["vmin"], kwargs["vmax"] = float(lo), float(hi)
    kwargs.update(imshow_kwargs)
    for ax, name, plane, aspect in zip(axes, names, (sag, cor, axi), aspects):
        disp = np.rot90(plane)
        flip_x = radiological and name in ("Coronal", "Axial")
        if flip_x:
            disp = np.fliplr(disp)
        ax.imshow(disp, aspect=aspect, **kwargs)
        if show_titles:
            ax.set_title(name, fontsize=9)
        if units in ("mm", "voxel"):
            _apply_ticks(ax, name, shape_ras, affine_ras, units=units, flip_x=flip_x)
        else:
            ax.set_xticks([])
            ax.set_yticks([])
        if intersections:
            _draw_intersections(ax, name, shape_ras, indices, flip_x=flip_x)
        elif crosshair:
            _draw_crosshair(ax, name, shape_ras, indices, flip_x=flip_x)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if output_path is not None:
        fig.savefig(output_path, **({"dpi": 120, "bbox_inches": "tight"} | (savefig_kwargs or {})))
    if show and output_path is None:  # pragma: no cover - interactive only
        plt.show()
    return fig


def plot_subject(
    subject: Subject,
    *,
    output_path: str | Path | None = None,
    show: bool = True,
    indices=None,
    coordinates=None,
    crosshair: bool = False,
    intersections: bool = False,
    cmap_dict: dict[str, Any] | None = None,
    title: str | None = None,
    figsize: tuple[float, float] | None = None,
    figsize_multiplier: float = 1.0,
    savefig_kwargs: dict[str, Any] | None = None,
    **kwargs: Any,
) -> Any:
    """Grid of 3-plane views, one row per image in the subject.

    All rows share the same slice point, given as RAS voxel ``indices``
    or world-mm ``coordinates``, resolved in the FIRST image's space and
    mapped through each image's affine, so ``crosshair=True`` /
    ``intersections=True`` lines mark the same WORLD point in every
    image. ``cmap_dict`` overrides the colormap per image name; a
    ``{label: (r, g, b)}`` dict value colorizes that label map with its
    color table (e.g. ``cmap_dict={"seg": FPG.GIF_COLORS}``). Up to 3
    images get a row each, with column widths proportional to the first
    image's physical extents; more than 3 images transpose the grid to one
    COLUMN per image. Extra keyword arguments are forwarded to
    :func:`plot_image` (and through it to ``ax.imshow``).
    """
    plt = _get_matplotlib()
    import matplotlib.gridspec as gridspec

    images = list(subject.images.items())
    if not images:
        raise RuntimeError("Subject has no images to plot")
    many = len(images) > 3

    # resolve the shared world point from the first image
    first_shape, first_affine = _ras_geometry(images[0][1])
    if coordinates is not None:
        if indices is not None:
            raise ValueError("Pass indices OR coordinates, not both")
        indices = _coordinates_to_indices(coordinates, first_affine, first_shape)
    if indices is None:
        indices = tuple(s // 2 for s in first_shape)
    world = first_affine @ np.array([*indices, 1.0])

    if many:
        # transposed grid: 3 view rows, one column per image
        figsize = figsize or (
            3.4 * len(images) * figsize_multiplier,
            10 * figsize_multiplier,
        )
        fig = plt.figure(figsize=figsize)
        gs = gridspec.GridSpec(3, len(images))
        axes_for = [[fig.add_subplot(gs[v, c]) for v in range(3)] for c in range(len(images))]
    else:
        # column widths proportional to the first image's physical
        # extents: sagittal shows (A, S), coronal/axial (R, *)
        spacing = np.linalg.norm(first_affine[:3, :3], axis=0)
        extents_mm = [s * sp for s, sp in zip(first_shape, spacing)]
        width_ratios = [extents_mm[1], extents_mm[0], extents_mm[0]]
        figsize = figsize or (
            10 * figsize_multiplier,
            3.4 * len(images) * figsize_multiplier,
        )
        fig = plt.figure(figsize=figsize)
        gs = gridspec.GridSpec(len(images), 3, width_ratios=width_ratios)
        axes_for = [[fig.add_subplot(gs[r, v]) for v in range(3)] for r in range(len(images))]

    for idx, (name, image) in enumerate(images):
        shape_ras, affine_ras = _ras_geometry(image)
        voxel = np.linalg.inv(affine_ras) @ world
        img_indices = tuple(
            int(np.clip(round(v), 0, s - 1)) for v, s in zip(voxel[:3], shape_ras)
        )
        row_kwargs = dict(kwargs)
        if cmap_dict and name in cmap_dict:
            row_kwargs["cmap"] = cmap_dict[name]
        plot_image(
            image,
            axes=axes_for[idx],
            show=False,
            title=None,
            indices=img_indices,
            crosshair=crosshair,
            intersections=intersections,
            show_titles=not many,
            **row_kwargs,
        )
        if many:
            axes_for[idx][0].set_title(name, fontsize=10)
        else:
            axes_for[idx][0].annotate(
                name,
                xy=(0, 0.5),
                xytext=(-axes_for[idx][0].yaxis.labelpad - 24, 0),
                xycoords=axes_for[idx][0].yaxis.label,
                textcoords="offset points",
                ha="right",
                va="center",
                fontsize=10,
                fontweight="bold",
                rotation=90,
            )
    if title is not None:
        fig.suptitle(title)
    fig.tight_layout()
    if output_path is not None:
        fig.savefig(output_path, **({"dpi": 120, "bbox_inches": "tight"} | (savefig_kwargs or {})))
    if show and output_path is None:  # pragma: no cover
        plt.show()
    return fig


def _frames_along_axis(image: Image, axis: int) -> list[np.ndarray]:
    """uint8 frames of channel 0 along RAS ``axis``: the volume scaled on
    the device, copied once, reoriented on the host (numpy views)."""
    volume = apply_orientation(_sweep_uint8(image.data[0]), _ras_ornt(image))
    return [np.rot90(np.take(volume, idx, axis=axis)) for idx in range(volume.shape[axis])]


#: Sweep-direction letter -> target orientation whose FIRST axis is the
#: sweep and whose remaining axes give an anatomically upright 2-D view.
_SWEEP_ORIENTATIONS = {
    "I": "IPL",
    "S": "SPL",
    "A": "AIL",
    "P": "PIL",
    "R": "RIP",
    "L": "LIP",
}


def _frames_for_direction(image: Image, direction: str, *, reverse: bool = False) -> list[np.ndarray]:
    """uint8 frames sweeping anatomically along ``direction`` (one of
    I/S/A/P/R/L): the image is reoriented (on its device) so the sweep is
    the first spatial axis and each frame is already upright."""
    from .transforms.spatial.reorient import Reorient

    direction = direction.upper()
    if direction not in _SWEEP_ORIENTATIONS:
        raise ValueError(
            f"direction must be one of {sorted(_SWEEP_ORIENTATIONS)}, got {direction!r}"
        )
    oriented = Reorient(orientation=_SWEEP_ORIENTATIONS[direction])(image)
    volume = _sweep_uint8(oriented.data[0])
    frames = [volume[idx] for idx in range(volume.shape[0])]
    return frames[::-1] if reverse else frames


def _sweep_frames(image, axis, direction, reverse) -> list[np.ndarray]:
    if direction is not None:
        return _frames_for_direction(image, direction, reverse=reverse)
    frames = _frames_along_axis(image, axis)
    return frames[::-1] if reverse else frames


def make_gif(
    image: Image,
    output_path: str | Path,
    *,
    axis: int = 2,
    direction: str | None = None,
    duration_ms: int = 40,
    seconds: float | None = None,
    reverse: bool = False,
    loop: int = 0,
    optimize: bool = True,
) -> Path:
    """Animated GIF sweeping through slices (Pillow).

    Either a RAS ``axis`` (0/1/2) or an anatomical ``direction``
    (``"I"``, ``"S"``, ``"A"``, ``"P"``, ``"R"``, ``"L"``); ``seconds``
    sets the full-animation duration (overrides ``duration_ms``; GIF
    delays quantize to 10 ms with a 20 ms floor for viewer
    compatibility)."""
    get_pil()
    from PIL import Image as PILImage

    frames = [PILImage.fromarray(f) for f in _sweep_frames(image, axis, direction, reverse)]
    if seconds is not None:
        duration_ms = max(round(seconds / len(frames) * 100) * 10, 20)
    output_path = Path(output_path)
    frames[0].save(
        output_path,
        save_all=True,
        append_images=frames[1:],
        duration=duration_ms,
        loop=loop,
        optimize=optimize,
    )
    return output_path


def make_video(
    image: Image,
    output_path: str | Path,
    *,
    axis: int = 2,
    direction: str | None = None,
    fps: int = 25,
    seconds: float | None = None,
    reverse: bool = False,
) -> Path:
    """MP4 slice sweep (requires the ffmpeg binary).

    ``direction`` sweeps anatomically (see :func:`make_gif`);
    ``seconds`` derives the frame rate from the slice count."""
    import shutil as _shutil
    import subprocess
    import tempfile

    if _shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg binary not found; install ffmpeg for videos")
    get_pil()
    from PIL import Image as PILImage

    output_path = Path(output_path)
    frames = _sweep_frames(image, axis, direction, reverse)
    if seconds is not None:
        fps = max(1, round(len(frames) / seconds))
    with tempfile.TemporaryDirectory() as tmp:
        for idx, frame in enumerate(frames):
            PILImage.fromarray(frame).save(f"{tmp}/{idx:05d}.png")
        subprocess.run(  # noqa: S603
            [
                "ffmpeg", "-y", "-framerate", str(fps),
                "-i", f"{tmp}/%05d.png",
                "-pix_fmt", "yuv420p",
                "-vf", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                str(output_path),
            ],
            check=True,
            capture_output=True,
        )
    return output_path
