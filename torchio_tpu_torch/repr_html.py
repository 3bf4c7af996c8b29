"""Jupyter HTML representations with base64-embedded preview plots.

Counterpart of ``torchio_tpu/repr_html.py``: styled metadata tables per
image, a sectioned subject view (Images / Points / Bounding Boxes /
Metadata / History) and inline preview renders via the Agg canvas. The
rows are the JAX package's: the dtype by its numpy name ("float32"), the
memory from :attr:`Image.memory` (the header's dtype for a lazy image).
A preview copies only the three drawn planes to the host
(:func:`..visualization.plot_image`). A preview that fails to render is
left out, but a fault of the card (``torch.AcceleratorError``, out of
memory) propagates.
"""

from __future__ import annotations

import base64
import html
import io

import torch

from .core.dtypes import dtype_name

#: Errors of the device that a preview must not hide.
_DEVICE_ERRORS = tuple(
    e for e in (getattr(torch, "AcceleratorError", None), torch.cuda.OutOfMemoryError) if e
)

#: Scoped CSS so the cards look consistent in any notebook theme.
_STYLE = """\
<style scoped>
.tio-card {
  border: 1px solid #ddd; border-radius: 8px; padding: 8px; margin: 4px;
  display: inline-block; font-family: sans-serif; vertical-align: top;
}
.tio-card b { font-size: 14px; }
.tio-kv td:first-child { padding: 0 8px; color: #666; }
.tio-kv td:last-child { padding: 0 8px; }
.tio-section {
  font-family: sans-serif; font-size: 13px; font-weight: bold;
  margin: 8px 0 2px 4px;
}
.tio-grid {
  border-collapse: collapse; font-family: monospace; font-size: 11px;
  margin: 4px;
}
.tio-grid th, .tio-grid td {
  text-align: left; padding: 3px 10px; border: 1px solid #ccc;
}
</style>"""


def _render_png(render) -> str | None:
    """Render a matplotlib figure factory to base64 PNG via the Agg
    canvas (never changes the global backend)."""
    try:
        import matplotlib.pyplot as plt
        from matplotlib.backends.backend_agg import FigureCanvasAgg

        fig = render()
        if fig is None:
            return None
        FigureCanvasAgg(fig)
        buffer = io.BytesIO()
        fig.savefig(buffer, format="png", dpi=72, bbox_inches="tight")
        plt.close(fig)
        return base64.b64encode(buffer.getvalue()).decode()
    except _DEVICE_ERRORS:
        raise
    except Exception:
        return None


def _preview_png(image) -> str | None:
    from . import visualization

    return _render_png(lambda: visualization.plot_image(image, show=False))


def _count(word: str, n: int) -> str:
    return f"1 {word}" if n == 1 else f"{n} {word}{'es' if word.endswith('x') else 's'}"


def _card(title: str, rows: list[tuple[str, str]], png: str | None) -> str:
    row_html = "".join(
        f"<tr><td>{html.escape(k)}</td>"
        f"<td><code>{html.escape(v)}</code></td></tr>"
        for k, v in rows
    )
    img_html = (
        f"<img src='data:image/png;base64,{png}' style='max-width:420px'/>"
        if png
        else ""
    )
    return (
        f"{_STYLE}<div class='tio-card'>"
        f"<b>{html.escape(title)}</b>"
        f"<table class='tio-kv'>{row_html}</table>{img_html}</div>"
    )


def _human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} GiB"  # pragma: no cover


def image_repr_html(image, *, name: str | None = None) -> str:
    rows = []
    try:
        rows.append(("channels", str(image.num_channels)))
        rows.append(("spatial shape", str(tuple(image.spatial_shape))))
        rows.append(
            ("spacing", ", ".join(f"{s:.2f}" for s in image.spacing) + " mm")
        )
        origin = image.affine.origin
        rows.append(
            ("origin", ", ".join(f"{v:.1f}" for v in origin) + " mm")
        )
        rows.append(("orientation", "".join(image.orientation) + "+"))
        try:
            angles = image.affine.euler_angles
            rows.append(
                ("euler angles", ", ".join(f"{a:.1f}°" for a in angles))
            )
        except Exception:
            pass
        rows.append(("dtype", dtype_name(image.dtype)))
        rows.append(("status", "loaded" if image.is_loaded else "lazy"))
        rows.append(("memory", _human_bytes(float(image.memory))))
        if image.path is not None:
            rows.append(("path", str(image.path)))
        for pts_name, pts in getattr(image, "points", {}).items():
            rows.append((f"points '{pts_name}'", _count("point", pts.num_points)))
        for box_name, boxes in getattr(image, "bounding_boxes", {}).items():
            rows.append((f"bboxes '{box_name}'", _count("box", boxes.num_boxes)))
        if image.applied_transforms:
            rows.append(
                ("history", " → ".join(t.name for t in image.applied_transforms))
            )
    except Exception as error:  # pragma: no cover
        rows.append(("error", str(error)))
    png = _preview_png(image) if image.is_loaded or image.path else None
    title = type(image).__name__ if name is None else f"{name} — {type(image).__name__}"
    return _card(title, rows, png)


def _grid(section: str, header: list[str], body: list[list[str]]) -> str:
    head = "".join(f"<th>{html.escape(h)}</th>" for h in header)
    rows = "".join(
        "<tr>" + "".join(f"<td>{html.escape(c)}</td>" for c in row) + "</tr>"
        for row in body
    )
    return (
        f"<div class='tio-section'>{html.escape(section)}</div>"
        f"<table class='tio-grid'><tr>{head}</tr>{rows}</table>"
    )


def _images_section(subject) -> str:
    body = []
    for name, image in subject.images.items():
        try:
            shape = str(tuple(image.shape))
            spacing = ", ".join(f"{s:.2f}" for s in image.spacing)
            orientation = "".join(image.orientation) + "+"
        except Exception:  # pragma: no cover - unreadable header
            shape = spacing = orientation = "?"
        body.append(
            [name, type(image).__name__, shape, spacing, orientation]
        )
    return _grid(
        "Images", ["Name", "Type", "Shape", "Spacing", "Orientation"], body
    )


def _points_section(subject) -> str:
    body = [
        [name, _count("point", pts.num_points), str(pts.axes)]
        for name, pts in subject.points.items()
    ]
    return _grid("Points", ["Name", "Count", "Axes"], body)


def _bboxes_section(subject) -> str:
    body = []
    for name, boxes in subject.bounding_boxes.items():
        fmt = boxes.format
        rep = getattr(getattr(fmt, "representation", None), "value", "")
        body.append(
            [name, _count("box", boxes.num_boxes), f"{fmt.axes} ({rep})"]
        )
    return _grid("Bounding Boxes", ["Name", "Count", "Format"], body)


def _metadata_section(subject) -> str:
    body = [[str(k), repr(v)] for k, v in subject.metadata.items()]
    return _grid("Metadata", ["Key", "Value"], body)


def subject_repr_html(subject) -> str:
    """Sectioned subject view: Images / Points / Bounding Boxes /
    Metadata tables, per-image cards with previews, history trail."""
    parts = [
        _STYLE,
        "<div class='tio-section' style='font-size:14px'>Subject</div>",
    ]
    if subject.images:
        parts.append(_images_section(subject))
    try:
        if subject.points:
            parts.append(_points_section(subject))
        if subject.bounding_boxes:
            parts.append(_bboxes_section(subject))
    except Exception:  # pragma: no cover
        pass
    if subject.metadata:
        parts.append(_metadata_section(subject))
    if subject.applied_transforms:
        parts.append(
            _grid(
                "History",
                ["#", "Transform"],
                [
                    [str(i + 1), t.name]
                    for i, t in enumerate(subject.applied_transforms)
                ],
            )
        )
    parts.extend(
        image_repr_html(img, name=name) for name, img in subject.images.items()
    )
    return "".join(parts)
