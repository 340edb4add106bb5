"""Headless viewer: composite 2x2 frame snapshots.

Behavioral reference: the GLUT/Qt front-ends' draw loop (drawthem,
se_apps/include/draw.h:51-112; QtGUI.cpp) which blits RGB / depth /
tracking-status / volume renders side by side. Without a display server
this writes the same composite as an image file per frame — the
practical headless equivalent of a live view.
"""

import numpy as np


def composite_views(depth_rgba, track_rgba, volume_rgba, rgb=None):
    """Assemble the 2x2 view grid (ref draw.h:51-112 layout)."""
    h, w = depth_rgba.shape[:2]
    if rgb is None:
        rgb = np.zeros((h, w, 4), np.uint8)
    elif rgb.shape[-1] == 3:
        rgb = np.concatenate([rgb, np.zeros((h, w, 1), np.uint8)], -1)
    top = np.concatenate([rgb, depth_rgba], axis=1)
    bottom = np.concatenate([track_rgba, volume_rgba], axis=1)
    return np.concatenate([top, bottom], axis=0)


def write_ppm(path, rgba):
    """Dependency-free image dump (P6 PPM)."""
    rgb = np.asarray(rgba)[..., :3]
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb).tobytes())


def snapshot(pipe, path, rgb=None):
    """Render the current pipeline state into a composite image file."""
    comp = composite_views(pipe.render_depth(), pipe.render_track(),
                           pipe.render_volume(), rgb)
    write_ppm(path, comp)
    return comp
