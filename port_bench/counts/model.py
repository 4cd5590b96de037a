"""Model FLOPs of the networks, from the widths and sizes in a
configuration's file:
2 x multiply-adds of every convolution, the count `torch.utils.
flop_counter` gives (a CPU test holds the two to each other on the plain
reference). Batch norm, activations, resizes, the crop and the decode are
not counted: the figure is the networks' work, as MFU counts it.
`counts/<arch>.py` adds up a served image of each kind of system."""

from __future__ import annotations

import math


def conv(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1,
         groups: int = 1):
    """(FLOPs, out h, out w) of a convolution with TF-SAME or symmetric
    padding (both give ceil(size / stride) for the odd kernels here)."""
    ho, wo = -(-h // stride), -(-w // stride)
    return 2.0 * ho * wo * cout * (cin // groups) * k * k, ho, wo


def round_filters(filters, width_mult, divisor=8):
    f = filters * width_mult
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


BASE_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
               (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
               (6, 320, 1, 1, 3))


def detector_flops(det: dict) -> float:
    """One image through EfficientDet-Lite at the configured size."""
    h, w = det["input_height"], det["input_width"]
    total, h, w = conv(h, w, 3, 32, 3, 2)
    cin, levels = 32, []
    for si, (e, c, r, s, k) in enumerate(BASE_STAGES):
        c = round_filters(c, det["width_mult"])
        reps = r if si in (0, 6) else int(math.ceil(det["depth_mult"] * r))
        for bi in range(reps):
            hid = cin * e
            if e != 1:
                total += conv(h, w, cin, hid, 1)[0]
            f, h, w = conv(h, w, hid, hid, k, s if bi == 0 else 1, hid)
            total += f + conv(h, w, hid, c, 1)[0]
            cin = c
        if si in (2, 4, 6):
            levels.append((c, h, w))
    fpn = det["fpn_channels"]
    c5, h5, w5 = levels[-1]
    if c5 != fpn:
        total += conv(h5, w5, c5, fpn, 1)[0]           # P6's channel adapt
    for _ in range(2):                                   # P6, P7: max pools
        h5, w5 = -(-h5 // 2), -(-w5 // 2)
        levels.append((fpn, h5, w5))
    sep = lambda h, w: conv(h, w, fpn, fpn, 3, 1, fpn)[0] + \
        conv(h, w, fpn, fpn, 1)[0]                      # noqa: E731
    chans = [c for c, _, _ in levels]
    n = len(levels)
    for _ in range(det["fpn_repeats"]):
        for i in range(n - 2, -1, -1):                 # top-down nodes
            _, h, w = levels[i]
            if chans[i] != fpn:
                total += conv(h, w, chans[i], fpn, 1)[0]
            total += sep(h, w)
        for i in range(1, n):                          # bottom-up nodes
            _, h, w = levels[i]
            if i < n - 1 and chans[i] != fpn:
                total += conv(h, w, chans[i], fpn, 1)[0]
            total += sep(h, w)
        chans = [fpn] * n
    for out in (9 * det["num_classes"], 9 * 4):        # class, box heads
        for _, h, w in levels:
            total += det["head_repeats"] * sep(h, w)
            total += conv(h, w, fpn, fpn, 3, 1, fpn)[0]
            total += conv(h, w, fpn, out, 1)[0]
    return total


def pose_flops(pose: dict) -> float:
    """One crop through HRNet at the configured width and crop size."""
    wd = pose["width"]
    total, h, w = conv(pose["crop_height"], pose["crop_width"], 3, 64, 3, 2)
    f, h, w = conv(h, w, 64, 64, 3, 2)
    total += f
    cin = 64
    for _ in range(4):                                  # layer1 bottlenecks
        total += conv(h, w, cin, 64, 1)[0] + conv(h, w, 64, 64, 3)[0] + \
            conv(h, w, 64, 256, 1)[0]
        if cin != 256:
            total += conv(h, w, cin, 256, 1)[0]
        cin = 256
    branches = [(cin, h, w)]                            # (channels, h, w)
    for s, n_mod in enumerate((1, 4, 3)):
        chans = [wd * 2 ** b for b in range(s + 2)]
        new = []
        for i, c in enumerate(chans):                   # transition
            if i >= len(branches):
                cp, hp, wp = branches[-1]
                f, ho, wo = conv(hp, wp, cp, c, 3, 2)
                total += f
                new.append((c, ho, wo))
            else:
                cp, hp, wp = branches[i]
                if cp != c:
                    total += conv(hp, wp, cp, c, 3)[0]
                new.append((c, hp, wp))
        branches = new
        for m in range(n_mod):
            for c, h, w in branches:                    # 4 basic blocks
                total += 4 * 2 * conv(h, w, c, c, 3)[0]
            n_out = 1 if (s == 2 and m == n_mod - 1) else len(branches)
            for i in range(n_out):                      # fusion into i
                ci, hi, wi = branches[i]
                for j, (cj, hj, wj) in enumerate(branches):
                    if j > i:
                        total += conv(hj, wj, cj, ci, 1)[0]
                    elif j < i:
                        h, w = hj, wj
                        for step in range(i - j):
                            cout = ci if step == i - j - 1 else cj
                            f, h, w = conv(h, w, cj, cout, 3, 2)
                            total += f
    c0, h0, w0 = branches[0]
    return total + conv(h0, w0, c0, pose["num_keypoints"], 1)[0]
