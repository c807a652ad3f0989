"""Faults planted in the program, to see `correct` come out false: the
checks' own tests drive a run over each, and the calibration reads each
training fault's numbers on the card. A fault is fault(driver) after the
driver built the program; it returns the undo."""
from __future__ import annotations

import importlib

VOXEL_SIZE = 0.3 / 40


def _patch(owner, attr, new):
    had = attr in vars(owner)
    old = getattr(owner, attr)
    setattr(owner, attr, new)

    def undo():
        if had:
            setattr(owner, attr, old)
        else:
            delattr(owner, attr)
    return undo


# ------------------------------------------------------------- planning
def stale(drv):
    """Each call answers with the previous call's grasps."""
    core, prev = drv.planner.core, []

    def stale_core(*args, **kw):
        out = core(*args, **kw)
        if prev:
            out, prev[0] = prev[0], out
        else:
            prev.append(out)
        return out
    return _patch(drv.planner, "core", stale_core)


def half_views(drv):
    """Half of the views left out: the views' means over the other half."""
    core = drv.planner.core

    def half(images, extrinsics, Ks, depth_range, *args, **kw):
        n = images.shape[0] // 2
        return core(images[:n], extrinsics[:n], Ks[:n], depth_range[:n],
                    *args, **kw)
    return _patch(drv.planner, "core", half)


def altered_grasp(drv):
    """The first grasp's width one voxel wider where the host makes it."""
    mod = importlib.import_module("graspnerf_tpu_torch.detect.planner")
    convert = mod.candidates_to_grasps

    def altered(*args, **kw):
        grasps, scores = convert(*args, **kw)
        if grasps:
            grasps[0] = (grasps[0][0], grasps[0][1] + VOXEL_SIZE)
        return grasps, scores
    return _patch(mod, "candidates_to_grasps", altered)


# ------------------------------------------------------------- training
def unchanged(drv):
    """The step leaves the parameters and the optimizer as they were."""
    trainer = importlib.import_module("graspnerf_tpu_torch.train.trainer")
    return _patch(trainer, "apply_gradients", lambda state, grads: True)


def half_rays(drv):
    """Half of the query rays left out: the render losses' means over the
    other half."""
    nr = drv.state.model.nr_net
    render = nr.render_rays

    def half(que, *args, **kw):
        n = que["coords"].shape[1] // 2
        return render(dict(que, coords=que["coords"][:, :n]), *args, **kw)
    return _patch(nr, "render_rays", half)


def altered_width(drv):
    """The grasp head's width half a voxel wider where it is produced."""
    def hook(module, args, out):
        qual, rot, width = out
        return qual, rot, width + 0.5
    handle = drv.state.model.vgn_net.register_forward_hook(hook)
    return handle.remove


FAULTS = {"plan": {"stale": stale, "half_views": half_views,
                   "altered": altered_grasp},
          "train": {"unchanged": unchanged, "half_rays": half_rays,
                    "altered": altered_width}}
