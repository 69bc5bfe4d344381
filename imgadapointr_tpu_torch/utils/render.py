"""3-D scatter renders of point clouds with numpy and PIL, without matplotlib.

The JAX package draws two figures with matplotlib's ``Axes3D.scatter``: the
KITTI test protocol's ``<model_id>_<index>.jpg`` (1 x 2 axes, ``figsize (8,
4)``, ``dpi 100``, ``s 0.4``, titles "input" and "prediction";
``imgadapointr_tpu/tools/runner.py:909-931``) and the serving CLI's
``input.jpg`` / ``fine.jpg`` under ``--save_vis_img`` (one axes, ``figsize
(4, 4)``, ``dpi 120``, ``s 0.5``; ``imgadapointr_tpu/tools/inference.py:
107-118``). Each axes has its axis turned off and matplotlib's default 3-D
view. This module reproduces matplotlib 3.10's geometry in numpy:

- the subplot boxes of the default ``subplotpars`` (left 0.125, right 0.9,
  bottom 0.11, top 0.88, wspace 0.2), made square and centred by
  ``Axes3D.apply_aspect``;
- the autoscaled limits: each axis's data range (made nonsingular), widened
  by the 0.05 margin on each side and then by the 1/48 view margin;
- ``Axes3D.get_proj``: the world box of aspect 4:4:3 (scaled to norm
  1.8294640721620434 x 25/24), elevation 30, azimuth -60, roll 0, a
  perspective projection of focal length 1 from the eye's distance 10;
- the 2-D view limits (-0.095, 0.09) on both axes mapped onto the box in
  pixels;
- ``depthshade``: each point's alpha ``1 - 0.7 (z - min z) / (max z - min
  z)`` of its projected depth, and ``Path3DCollection``'s draw order
  (``argsort`` of the depth, reversed).

Each point is drawn as Agg draws matplotlib's marker: the face, a disc of
diameter ``sqrt(s)`` points, and over it the edge in the face's colour
(``scatter``'s default ``edgecolors='face'``, ``patch.linewidth`` 1 point
wide): the ring from ``|r - w / 2|`` to ``r + w / 2`` about the face's
radius ``r``, for an edge width ``w``. Where the edge is wider than the
face's diameter, as here, Agg's nonzero fill of the stroked outline leaves
the hole of radius ``w / 2 - r``. Both take the point's alpha and colour C0
(``#1f77b4``) and are composited on white, back to front; with one colour
the result does not depend on the order. Coverage at a pixel is the share
of a 4 x 4 grid of samples inside the shape (Agg's antialiasing,
approximated). The titles are drawn with PIL's default font,
centred on matplotlib's title anchor (the axes' top centre, 6 points
above) and standing on it; their glyphs and size differ from matplotlib's
14.4 points. The JPEG is
written by PIL at its default quality, as matplotlib's ``savefig`` does.
"""

from __future__ import annotations

import numpy as np

C0 = np.array([0x1F, 0x77, 0xB4], np.float64)
SUBPLOT = {"left": 0.125, "right": 0.9, "bottom": 0.11, "top": 0.88, "wspace": 0.2}
ELEV, AZIM = 30.0, -60.0
DIST = 10.0  # the camera's distance
FOCAL = 1.0
BOX_ASPECT = np.array([4.0, 4.0, 3.0]) * (1.8294640721620434 * 25 / 24 / np.linalg.norm([4.0, 4.0, 3.0]))
MARGIN = 0.05  # axes.xmargin, axes.ymargin and the z margin scatter sets
VIEW_MARGIN = 1 / 48
VIEW_LIM = (-0.95 / DIST, 0.9 / DIST)  # Axes3D.set_top_view, on x and y
EDGE_PT = 1.0  # patch.linewidth: scatter's edge width for a filled marker
DEPTH_SHADE = 0.7
TITLE_PAD_PT = 6.0  # axes.titlepad
SAMPLES = 4  # coverage samples a pixel on each axis
CHUNK = 2048  # points composited at a time (bounds the sample arrays)

KITTI_FIGURE = {"figsize": (8, 4), "dpi": 100, "s": 0.4}
CLI_FIGURE = {"figsize": (4, 4), "dpi": 120, "s": 0.5}


def axes_boxes(n: int, figsize: tuple) -> list:
    """``(left, bottom, width, height)`` in figure fractions of each of a
    1 x ``n`` grid of 3-D axes after ``apply_aspect`` (matplotlib's
    ``GridSpec.get_grid_positions`` and ``Bbox.shrunk_to_aspect`` /
    ``anchored('C')``)."""
    left, right, bottom, top = SUBPLOT["left"], SUBPLOT["right"], SUBPLOT["bottom"], SUBPLOT["top"]
    cell_w = (right - left) / (n + SUBPLOT["wspace"] * (n - 1))
    sep_w = SUBPLOT["wspace"] * cell_w
    cell_ws = np.cumsum(np.column_stack([[0] + [sep_w] * (n - 1), [cell_w] * n]).flat)
    fig_aspect = figsize[1] / figsize[0]
    out = []
    for i in range(n):
        l, r = left + cell_ws[2 * i], left + cell_ws[2 * i + 1]
        w, h = r - l, top - bottom
        shrunk_h = w / fig_aspect
        if shrunk_h <= h:
            sw, sh = w, shrunk_h
        else:
            sw, sh = h * fig_aspect, h
        out.append((l + 0.5 * (w - sw), bottom + 0.5 * (h - sh), sw, sh))
    return out


def _nonsingular(v0: float, v1: float, expander: float = 0.05, tiny: float = 1e-15) -> tuple:
    """matplotlib's ``transforms.nonsingular`` (the locators' default)."""
    if not (np.isfinite(v0) and np.isfinite(v1)):
        return -expander, expander
    if v1 < v0:
        v0, v1 = v1, v0
    maxabs = max(abs(v0), abs(v1))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if v1 - v0 <= maxabs * tiny:
        if v1 == 0 and v0 == 0:
            return -expander, expander
        return v0 - expander * abs(v0), v1 + expander * abs(v1)
    return v0, v1


def limits(cloud: np.ndarray) -> list:
    """The autoscaled ``(low, high)`` of x, y and z after one scatter of
    ``cloud`` (``Axes3D.autoscale_view`` then ``_set_lim3d``)."""
    out = []
    for k in range(3):
        v0, v1 = _nonsingular(float(np.min(cloud[:, k])), float(np.max(cloud[:, k])))
        delta = (v1 - v0) * MARGIN
        v0, v1 = _nonsingular(v0 - delta, v1 + delta)
        delta = (v1 - v0) * VIEW_MARGIN
        out.append((v0 - delta, v1 + delta))
    return out


def projection(lims: list) -> np.ndarray:
    """``Axes3D.get_proj``'s 4 x 4 matrix for the limits ``lims``."""
    (x0, x1), (y0, y1), (z0, z1) = lims
    dx, dy, dz = (x1 - x0) / BOX_ASPECT[0], (y1 - y0) / BOX_ASPECT[1], (z1 - z0) / BOX_ASPECT[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy], [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
    r = 0.5 * BOX_ASPECT
    elev, azim = np.deg2rad(ELEV), np.deg2rad(AZIM)
    ps = np.array([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)])
    eye = r + DIST * ps
    w = (eye - r) / np.linalg.norm(eye - r)
    u = np.cross(np.array([0.0, 0.0, 1.0]), w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, move = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    move[:3, -1] = -(r + DIST * ps * FOCAL)
    view = np.dot(rot, move)
    zf, zb = -DIST, DIST
    persp = np.array([[FOCAL, 0, 0, 0], [0, FOCAL, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * (zf * zb) / (zf - zb)], [0, 0, -1, 0]])
    return np.dot(persp, np.dot(view, world))


def project(cloud: np.ndarray, box_px: tuple) -> tuple:
    """The scatter of ``cloud`` (N, 3) in an axes whose box in display
    pixels (origin bottom left) is ``box_px`` = (left, bottom, width,
    height): each point's display position (N, 2), its alpha (N,) and the
    draw order (indices, first drawn first)."""
    cloud = np.asarray(cloud)
    m = projection(limits(cloud))
    vec = np.array([cloud[:, 0], cloud[:, 1], cloud[:, 2], np.ones(len(cloud), cloud.dtype)])
    vecw = np.dot(m, vec)
    vx, vy, vz = vecw[0] / vecw[3], vecw[1] / vecw[3], vecw[2] / vecw[3]
    order = np.argsort(vz)[::-1]
    lo, hi = VIEW_LIM
    left, bottom, width, height = box_px
    xy = np.stack([left + (vx - lo) / (hi - lo) * width, bottom + (vy - lo) / (hi - lo) * height], axis=1)
    vmin, vmax = np.min(vz), np.max(vz)
    norm = (vz - vmin) / (vmax - vmin) if vmax > vmin else np.zeros_like(vz)
    return xy, 1.0 - norm * DEPTH_SHADE, order


def _composite(transmit: np.ndarray, xy: np.ndarray, alpha: np.ndarray, inner: float, radius: float) -> None:
    """Multiply ``transmit`` (H, W: the share of white left at each pixel)
    by ``1 - alpha * coverage`` of the ring from ``inner`` to ``radius``
    pixels (a disc where ``inner`` is 0) about each display position
    ``xy``, in order."""
    for start in range(0, len(xy), CHUNK):
        _composite_chunk(transmit, xy[start:start + CHUNK], alpha[start:start + CHUNK], inner, radius)


def _composite_chunk(transmit: np.ndarray, xy: np.ndarray, alpha: np.ndarray, inner: float,
                     radius: float) -> None:
    h, w = transmit.shape
    cols, rows = xy[:, 0], h - xy[:, 1]  # image coordinates: pixel (r, c) spans [c, c + 1) x [r, r + 1)
    reach = int(np.ceil(radius)) + 1
    off = np.arange(-reach, reach + 1)
    sub = (np.arange(SAMPLES) + 0.5) / SAMPLES
    pc = np.floor(cols).astype(np.int64)[:, None, None] + off[None, None, :]
    pr = np.floor(rows).astype(np.int64)[:, None, None] + off[None, :, None]
    dx = pc[..., None, None] + sub[None, None, None, None, :] - cols[:, None, None, None, None]
    dy = pr[..., None, None] + sub[None, None, None, :, None] - rows[:, None, None, None, None]
    d2 = dx * dx + dy * dy
    cover = ((d2 < radius * radius) & (d2 >= inner * inner)).mean(axis=(-1, -2))
    keep = (pr >= 0) & (pr < h) & (pc >= 0) & (pc < w) & (cover > 0)
    pr, pc = np.broadcast_arrays(pr, pc)
    np.multiply.at(transmit.reshape(-1), (pr * w + pc)[keep],
                   1.0 - (alpha[:, None, None] * cover)[keep])


def scatter_figure(path: str, clouds: list, titles, figsize: tuple, dpi: int, s: float) -> None:
    """Write a JPEG of 1 x ``len(clouds)`` 3-D scatter plots of ``clouds``
    (each (N, 3)), with ``titles`` (or None) above the axes, as matplotlib's
    ``savefig(path, dpi=dpi)`` of such a figure."""
    from PIL import Image, ImageDraw, ImageFont

    width, height = int(round(figsize[0] * dpi)), int(round(figsize[1] * dpi))
    transmit = np.ones((height, width))
    face = 0.5 * np.sqrt(s) * dpi / 72.0
    half_edge = 0.5 * EDGE_PT * dpi / 72.0
    anchors = []
    for cloud, (l, b, w, h) in zip(clouds, axes_boxes(len(clouds), figsize)):
        box = (l * width, b * height, w * width, h * height)
        xy, alpha, order = project(cloud, box)
        _composite(transmit, xy[order], alpha[order], 0.0, face)
        _composite(transmit, xy[order], alpha[order], abs(face - half_edge), face + half_edge)
        anchors.append((box[0] + 0.5 * box[2], height - (box[1] + box[3]) - TITLE_PAD_PT * dpi / 72.0))
    rgb = 255.0 - (255.0 - C0) * (1.0 - transmit[..., None])
    image = Image.fromarray(np.clip(np.rint(rgb), 0, 255).astype(np.uint8), "RGB")
    if titles:
        draw = ImageDraw.Draw(image)
        font = ImageFont.load_default()
        for (x, y), title in zip(anchors, titles):
            left, _, right, bottom = draw.textbbox((0, 0), title, font=font)
            draw.text((x - 0.5 * (left + right), y - bottom), title, fill=(0, 0, 0), font=font)
    image.save(path, format="jpeg", dpi=(dpi, dpi))


def save_kitti(path: str, partial: np.ndarray, dense: np.ndarray) -> None:
    """The KITTI test protocol's image: the input and the prediction side by side."""
    scatter_figure(path, [partial, dense], ("input", "prediction"), **KITTI_FIGURE)


def save_cloud(path: str, cloud: np.ndarray) -> None:
    """The serving CLI's render of one cloud."""
    scatter_figure(path, [cloud], None, **CLI_FIGURE)
