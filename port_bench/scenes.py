"""Seeded one-person scenes with analytic truth: the benchmark's frozen
copy of the measured program's `training/synthetic.generate_scene`
(numpy + cv2), which rendered the scenes the certified weights were
trained and certified on. The same seed renders the same pixels,
keypoints and height here as there (a CPU test holds them to each other);
the copy keeps the yardstick fixed while the program changes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

# ---------------------------------------------------------------------- #
# anthropometry (fractions of total height H, classic 7.5-head figure)

_ANKLE_Y = 0.046
_KNEE_Y = 0.285
_HIP_Y = 0.52
_SHOULDER_Y = 0.815
_NOSE_Y = 0.925
_EYE_Y = 0.940
_EAR_Y = 0.930
_HIP_HALFW = 0.066
_SHOULDER_HALFW = 0.114
_EYE_DX = 0.023
_EAR_DX = 0.044
_UPPER_ARM = 0.172
_FOREARM = 0.155

_HEAD_RX = 0.050
_HEAD_RY = 0.068
_NECK_R = 0.021
_ARM_R = 0.026
_LEG_R = 0.042
_HAND_R = 0.024
_FOOT_RX = 0.055
_FOOT_RY = 0.025

_SKIN_TONES = [
    (244, 208, 177), (224, 172, 138), (198, 134, 94),
    (141, 85, 52), (94, 60, 40),
]

@dataclasses.dataclass
class SyntheticScene:
    image: np.ndarray       # [H, W, 3] uint8 RGB
    keypoints: np.ndarray   # [17, 2] float32 (x, y) image px
    visible: np.ndarray     # [17] bool (frontal standing: all True)
    bbox_xyxy: np.ndarray   # [4] float32 tight person box, image px
    height_cm: float


def _skeleton_cm(
    height_cm: float, rng: np.random.Generator, fixed_pose: bool
) -> Tuple[np.ndarray, dict]:
    """17 keypoints in body coords (cm; x right, y up from ground=0) plus
    the derived joint dict used by the renderer."""
    H = height_cm

    def ang(lo, hi):
        return 0.5 * (lo + hi) if fixed_pose else float(rng.uniform(lo, hi))

    kp = np.zeros((17, 2), np.float64)
    # face
    kp[0] = (0.0, _NOSE_Y * H)                       # nose
    kp[1] = (-_EYE_DX * H, _EYE_Y * H)               # reye (subject right)
    kp[2] = (+_EYE_DX * H, _EYE_Y * H)               # leye
    kp[3] = (-_EAR_DX * H, _EAR_Y * H)               # rear
    kp[4] = (+_EAR_DX * H, _EAR_Y * H)               # lear
    # shoulders / hips
    kp[5] = (-_SHOULDER_HALFW * H, _SHOULDER_Y * H)  # rshoulder
    kp[6] = (+_SHOULDER_HALFW * H, _SHOULDER_Y * H)  # lshoulder
    kp[11] = (-_HIP_HALFW * H, _HIP_Y * H)           # rhip
    kp[12] = (+_HIP_HALFW * H, _HIP_Y * H)           # lhip

    joints = {}
    # arms: per-side shoulder abduction + elbow bend (degrees from
    # straight-down)
    for side, sh_i, el_i, wr_i in ((-1, 5, 7, 9), (+1, 6, 8, 10)):
        a = np.deg2rad(ang(10.0, 62.0))
        b = np.deg2rad(ang(-18.0, 50.0))
        sh = kp[sh_i]
        el = sh + _UPPER_ARM * H * np.array([side * np.sin(a), -np.cos(a)])
        wr = el + _FOREARM * H * np.array(
            [side * np.sin(a + b), -np.cos(a + b)]
        )
        kp[el_i] = el
        kp[wr_i] = wr
    # legs: slight outward splay; shank follows through to the ankle line
    thigh = (_HIP_Y - _KNEE_Y) * H
    shank = (_KNEE_Y - _ANKLE_Y) * H
    for side, hip_i, kn_i, an_i in ((-1, 11, 13, 15), (+1, 12, 14, 16)):
        s1 = np.deg2rad(ang(0.0, 9.0))
        s2 = np.deg2rad(ang(0.0, 6.0))
        hip = kp[hip_i]
        kn = hip + thigh * np.array([side * np.sin(s1), -np.cos(s1)])
        an = kn + shank * np.array([side * np.sin(s2), -np.cos(s2)])
        kp[kn_i] = kn
        kp[an_i] = an
    return kp, joints


def _scene_primitives(kp: np.ndarray, H: float):
    """Renderable primitives + their exact extents, in body cm coords.

    Returns (capsules, ellipses, polygons):
      capsule  = (p1, p2, radius, kind)
      ellipse  = (center, rx, ry, kind)
      polygon  = ([pts], kind)
    kind picks the color role: 'skin' | 'shirt' | 'pants' | 'shoe'.
    """
    capsules: List[tuple] = []
    ellipses: List[tuple] = []
    polygons: List[tuple] = []

    chest = 0.5 * (kp[5] + kp[6])
    crotch = 0.5 * (kp[11] + kp[12])
    head_center = np.array([0.0, H - _HEAD_RY * H])

    # torso: shoulder-to-hip quad with a small margin, shirt-colored
    m = 0.018 * H
    quad = [
        kp[5] + (-m, +m), kp[6] + (+m, +m),
        kp[12] + (+m, -0.02 * H), kp[11] + (-m, -0.02 * H),
    ]
    polygons.append(([np.asarray(p) for p in quad], "shirt"))
    capsules.append((chest, crotch, 0.07 * H, "shirt"))
    # neck
    capsules.append((chest, head_center, _NECK_R * H, "skin"))
    # head (top exactly at y = H)
    ellipses.append((head_center, _HEAD_RX * H, _HEAD_RY * H, "skin"))
    # arms (shirt upper, skin forearm) + hands
    for sh_i, el_i, wr_i in ((5, 7, 9), (6, 8, 10)):
        capsules.append((kp[sh_i], kp[el_i], _ARM_R * H, "shirt"))
        capsules.append((kp[el_i], kp[wr_i], _ARM_R * 0.9 * H, "skin"))
        ellipses.append((kp[wr_i], _HAND_R * H, _HAND_R * H, "skin"))
    # legs (pants)
    for hip_i, kn_i, an_i in ((11, 13, 15), (12, 14, 16)):
        capsules.append((kp[hip_i], kp[kn_i], _LEG_R * H, "pants"))
        capsules.append((kp[kn_i], kp[an_i], _LEG_R * 0.85 * H, "pants"))
        # shoe: ellipse whose bottom is exactly y = 0
        ankle_x = kp[an_i][0]
        ellipses.append((
            np.array([ankle_x, _FOOT_RY * H]),
            _FOOT_RX * H, _FOOT_RY * H, "shoe",
        ))
    return capsules, ellipses, polygons


def _extents_cm(capsules, ellipses, polygons) -> np.ndarray:
    """Exact tight extents [x1, y1, x2, y2] (cm) of the drawn figure."""
    xs, ys = [], []
    for p1, p2, r, _ in capsules:
        for p in (p1, p2):
            xs += [p[0] - r, p[0] + r]
            ys += [p[1] - r, p[1] + r]
    for c, rx, ry, _ in ellipses:
        xs += [c[0] - rx, c[0] + rx]
        ys += [c[1] - ry, c[1] + ry]
    for pts, _ in polygons:
        for p in pts:
            xs.append(p[0])
            ys.append(p[1])
    return np.array([min(xs), min(ys), max(xs), max(ys)], np.float64)


def _draw_figure(
    canvas: np.ndarray,
    colors: dict,
    kp_cm: np.ndarray,
    capsules,
    ellipses,
    polygons,
    s: float,
    cx: float,
    feet_py: float,
    H: float,
) -> np.ndarray:
    """Rasterize one figure (primitives in body-cm coords) onto `canvas`
    at scale `s` px/cm, horizontally centered at `cx`, feet line at
    `feet_py`. Pure drawing — consumes no RNG (colors are passed in), so
    single- and multi-person generators share it without perturbing each
    other's seeded streams. Returns the keypoints in image px [17, 2]."""
    import cv2

    SHIFT = 4
    SC = 1 << SHIFT

    def to_px(p_cm):
        return np.array([cx + p_cm[0] * s, feet_py - p_cm[1] * s])

    def ipt(p_px):
        return (int(round(p_px[0] * SC)), int(round(p_px[1] * SC)))

    for pts, kind in polygons:
        poly = np.array([ipt(to_px(p)) for p in pts], np.int32)
        cv2.fillPoly(canvas, [poly], colors[kind], cv2.LINE_AA,
                     shift=SHIFT)
    for p1, p2, r, kind in capsules:
        q1, q2 = to_px(p1), to_px(p2)
        rp = max(int(round(r * s)), 1)
        cv2.line(canvas, (int(round(q1[0])), int(round(q1[1]))),
                 (int(round(q2[0])), int(round(q2[1]))), colors[kind],
                 thickness=2 * rp, lineType=cv2.LINE_AA)
        for q in (q1, q2):
            cv2.circle(canvas, ipt(q), int(round(r * s * SC)),
                       colors[kind], -1, cv2.LINE_AA, shift=SHIFT)
    for c, rx, ry, kind in ellipses:
        cv2.ellipse(canvas, ipt(to_px(c)),
                    (int(round(rx * s * SC)), int(round(ry * s * SC))),
                    0, 0, 360, colors[kind], -1, cv2.LINE_AA, shift=SHIFT)
    # simple face marks so left/right is visually (and network-) resolvable
    dark = (40, 30, 30)
    for i in (1, 2):
        cv2.circle(canvas, ipt(to_px(kp_cm[i])),
                   max(int(round(0.008 * H * s * SC)), SC), dark, -1,
                   cv2.LINE_AA, shift=SHIFT)
    cv2.circle(canvas, ipt(to_px(kp_cm[0])),
               max(int(round(0.006 * H * s * SC)), SC), (150, 80, 70), -1,
               cv2.LINE_AA, shift=SHIFT)
    return np.stack([to_px(p) for p in kp_cm]).astype(np.float32)


def _draw_background(
    canvas_hw: Tuple[int, int], rng: np.random.Generator
) -> np.ndarray:
    """Gradient + random clutter background (the exact drawing sequence
    generate_scene uses, factored for the multi-person generator)."""
    import cv2

    img_h, img_w = canvas_hw
    c0 = rng.integers(30, 226, 3).astype(np.float32)
    c1 = rng.integers(30, 226, 3).astype(np.float32)
    t = np.linspace(0.0, 1.0, img_h, dtype=np.float32)[:, None, None]
    img = (c0 * (1 - t) + c1 * t) * np.ones((1, img_w, 1), np.float32)
    canvas = img.astype(np.uint8).copy()
    for _ in range(int(rng.integers(0, 5))):
        col = tuple(int(v) for v in rng.integers(0, 256, 3))
        x0, y0 = int(rng.integers(0, img_w)), int(rng.integers(0, img_h))
        x1 = int(rng.integers(0, img_w))
        y1 = int(rng.integers(0, img_h))
        if rng.random() < 0.5:
            cv2.rectangle(canvas, (min(x0, x1), min(y0, y1)),
                          (max(x0, x1), max(y0, y1)), col, -1)
        else:
            cv2.ellipse(canvas, (x0, y0),
                        (int(rng.integers(8, img_w // 3)),
                         int(rng.integers(8, img_h // 3))),
                        0, 0, 360, col, -1)
    return canvas


def _figure_colors(rng: np.random.Generator) -> dict:
    skin = _SKIN_TONES[int(rng.integers(0, len(_SKIN_TONES)))]
    shirt = tuple(int(v) for v in rng.integers(20, 236, 3))
    pants = tuple(int(v) for v in rng.integers(20, 236, 3))
    shoe = tuple(int(v) for v in rng.integers(10, 90, 3))
    return {"skin": skin, "shirt": shirt, "pants": pants, "shoe": shoe}


def generate_scene(
    rng: np.random.Generator,
    img_hw: Tuple[int, int] = (480, 640),
    height_cm: float | None = None,
    fixed_pose: bool = False,
) -> SyntheticScene:
    """Render one scene; all label quantities are analytic (no pixel scan).

    `fixed_pose=True` freezes the joint angles AND the placement at their
    midpoints (only appearance varies) — the easy task the fast CPU
    certification test trains in-test; the chip run uses varied poses.
    """
    img_h, img_w = img_hw
    H = float(height_cm if height_cm is not None
              else rng.uniform(150.0, 200.0))
    kp_cm, _ = _skeleton_cm(H, rng, fixed_pose)
    capsules, ellipses, polygons = _scene_primitives(kp_cm, H)
    ext = _extents_cm(capsules, ellipses, polygons)  # figure extents, cm

    # placement: figure height fills a fraction of the image; keep the
    # whole drawn extent >= 2 px inside the frame
    frac = 0.75 if fixed_pose else float(rng.uniform(0.60, 0.92))
    s = frac * img_h / H                       # px per cm
    half_w_px = max(-ext[0], ext[2]) * s
    cx_lo, cx_hi = half_w_px + 3.0, img_w - half_w_px - 3.0
    cx = 0.5 * img_w if fixed_pose else float(rng.uniform(cx_lo, cx_hi))
    feet_margin = 0.04 if fixed_pose else float(rng.uniform(0.015, 0.07))
    feet_py = img_h - 3.0 - feet_margin * img_h * 0.5
    feet_py = min(feet_py, img_h - 3.0)
    top_py = feet_py - H * s
    if top_py < 3.0:                           # keep head in frame
        s = (feet_py - 3.0) / H

    def to_px(p_cm):
        return np.array([cx + p_cm[0] * s, feet_py - p_cm[1] * s])

    canvas = _draw_background(img_hw, rng)
    colors = _figure_colors(rng)
    kp_px = _draw_figure(canvas, colors, kp_cm, capsules, ellipses,
                         polygons, s, cx, feet_py, H)

    noise = rng.normal(0.0, 5.0, canvas.shape)
    canvas = np.clip(canvas.astype(np.float32) + noise, 0, 255) \
        .astype(np.uint8)

    x1, y1 = to_px((ext[0], ext[3]))  # cm y-up -> px y-down flips the box
    x2, y2 = to_px((ext[2], ext[1]))
    bbox = np.array([x1, y1, x2, y2], np.float32)
    return SyntheticScene(
        image=canvas,
        keypoints=kp_px,
        visible=np.ones(17, bool),
        bbox_xyxy=bbox,
        height_cm=H,
    )
