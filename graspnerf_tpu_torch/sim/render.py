"""Domain-randomized scene renderer — the rd/ analog
(graspnerf_tpu/sim/render.py, the same numpy on the host).

The reference renders photoreal training/eval images with Blender Cycles plus
a large procedural-material library (ref: src/rd/render.py:9-332,
rd/render_utils.py:492-1501, rd/modify_material.py). Blender is an external
host-side process there; here the same three-call contract

  init_scene(scene)            (ref rd/render.py:9   blender_init_scene)
  render_views(scene, ...)     (ref rd/render.py:254 blender_render)
  update_sceneobj(scene)       (ref rd/render.py:238 blender_update_sceneobj)

is served by a native ray tracer (C++/OpenMP via sim.objects.PrimScene.trace)
with randomized Blinn-Phong materials per material class, randomized
multi-light rigs with shadow rays, and procedural floor/table textures. The
on-disk contract matches the reference's exactly — rgb/%04d.png +
camera_pose.npy (+ depth/mask arrays) — so the planner-side loader
(detect.planner.load_rendered_views) cannot tell the two apart.

When real Blender is wanted, run it as the host process exactly like the
reference (run_simgrasp.sh) — nothing in this module imports bpy.

The committed textures are stored as uint8 arrays (assets/textures/*.npz,
key 'img'), equal to what PIL decodes from the JAX package's PNGs, so a
render needs no image library; PIL is imported only to read user image
directories and to write PNGs (`render_views_to_dir`).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .objects import PrimScene

# material classes — all 11 reference families (ref rd/modify_material.py:
# metal / porcelain / plastic / paint / glass / rubber / paper / leather /
# wood / clay / fabric), keyed by PrimObject.material % len. Glass renders
# with one-bounce Fresnel reflection + transmission (ref modify_material.py
# :1490-1598 glass node graphs); leather/fabric get bumpy/woven albedo noise.
MATERIAL_CLASSES = (
    "metal", "porcelain", "plastic", "paint", "glass",
    "rubber", "paper", "leather", "wood", "clay", "fabric",
)

_CLASS_PARAMS = {
    #            spec,  shininess, metallic, albedo value-range
    "metal":     (0.9,  48.0,      0.9,      (0.3, 0.8)),
    "porcelain": (0.7,  64.0,      0.0,      (0.6, 0.95)),
    "plastic":   (0.5,  32.0,      0.0,      (0.2, 0.9)),
    "paint":     (0.4,  24.0,      0.0,      (0.2, 0.9)),
    "glass":     (0.9,  96.0,      0.0,      (0.7, 0.98)),
    "rubber":    (0.1,  8.0,       0.0,      (0.05, 0.5)),
    "paper":     (0.05, 4.0,       0.0,      (0.5, 0.95)),
    "leather":   (0.25, 10.0,      0.0,      (0.1, 0.55)),
    "wood":      (0.2,  12.0,      0.0,      (0.25, 0.7)),
    "clay":      (0.15, 8.0,       0.0,      (0.3, 0.7)),
    "fabric":    (0.02, 2.0,       0.0,      (0.15, 0.8)),
}

# albedo texture noise (amplitude, scale) per class — leather grain / wood
# rings / fabric weave analogs of the reference's procedural node textures
_CLASS_TEXTURE = {"leather": (0.25, 220.0), "fabric": (0.3, 420.0),
                  "wood": (0.2, 60.0), "clay": (0.12, 90.0)}

# material classes that may bind an IMAGE texture instead of closed-form noise
# (the reference maps ImageNet crops / real floor+table photos onto objects —
# ref rd/render.py:20-110,169-213); images come from the committed equirect/
# texture bank (assets/) or, when present, real images in $GRASPNERF_TEX_DIR
_IMAGE_TEXTURE_CLASSES = ("wood", "fabric", "paper", "leather", "paint")


class EnvMap:
    """Equirectangular environment image with bilinear direction lookup —
    the image-based analog of the reference's HDRI world lighting
    (ref rd/render_utils.py env-map setup; rd/render.py:20-110)."""

    def __init__(self, img: np.ndarray, strength: float = 1.0):
        self.img = np.asarray(img, np.float32)  # [H, W, 3], equirect
        self.strength = float(strength)

    def sample(self, dirs: np.ndarray) -> np.ndarray:
        d = dirs / (np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-9)
        H, W, _ = self.img.shape
        u = (np.arctan2(d[..., 1], d[..., 0]) / (2 * np.pi) + 0.5) * W - 0.5
        v = (0.5 - np.arcsin(np.clip(d[..., 2], -1, 1)) / np.pi) * H - 0.5
        u0 = np.floor(u).astype(np.int64)
        v0 = np.floor(v).astype(np.int64)
        fu, fv = (u - u0)[..., None], (v - v0)[..., None]
        u0 %= W
        u1 = (u0 + 1) % W                       # azimuth wraps
        v0c = np.clip(v0, 0, H - 1)
        v1c = np.clip(v0 + 1, 0, H - 1)         # poles clamp
        im = self.img
        out = (im[v0c, u0] * (1 - fv) * (1 - fu) + im[v0c, u1] * (1 - fv) * fu
               + im[v1c, u0] * fv * (1 - fu) + im[v1c, u1] * fv * fu)
        return (out * self.strength).astype(np.float32)


def _assets_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets")


_ENV_BANK: list = []
_TEX_BANK: list = []


def load_env_bank() -> list:
    """Committed equirect env maps (assets/envmaps/*.npz, key 'img') plus any
    user HDRIs in $GRASPNERF_HDRI_DIR (png/npy equirects)."""
    global _ENV_BANK
    if _ENV_BANK:
        return _ENV_BANK
    bank = []
    d = os.path.join(_assets_dir(), "envmaps")
    if os.path.isdir(d):
        for f in sorted(os.listdir(d)):
            if f.endswith(".npz"):
                bank.append(np.load(os.path.join(d, f))["img"]
                            .astype(np.float32))
    ext_dir = os.environ.get("GRASPNERF_HDRI_DIR")
    if ext_dir and os.path.isdir(ext_dir):
        from PIL import Image
        for f in sorted(os.listdir(ext_dir)):
            p = os.path.join(ext_dir, f)
            if f.endswith(".npy"):
                bank.append(np.load(p).astype(np.float32))
            elif f.lower().endswith((".png", ".jpg", ".jpeg")):
                bank.append(np.asarray(Image.open(p), np.float32) / 255.0)
    _ENV_BANK = bank
    return bank


def load_texture_bank() -> list:
    """Committed albedo texture images (assets/textures/*.npz, key 'img',
    uint8 RGB) plus any real images in $GRASPNERF_TEX_DIR — the
    ImageNet-texture analog."""
    global _TEX_BANK
    if _TEX_BANK:
        return _TEX_BANK
    bank = []
    d = os.path.join(_assets_dir(), "textures")
    for f in sorted(os.listdir(d)):
        if f.endswith(".npz"):
            bank.append(np.asarray(np.load(os.path.join(d, f))["img"],
                                   np.float32) / 255.0)
    ext_dir = os.environ.get("GRASPNERF_TEX_DIR")
    if ext_dir and os.path.isdir(ext_dir):
        from PIL import Image
        for f in sorted(os.listdir(ext_dir)):
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                bank.append(np.asarray(
                    Image.open(os.path.join(ext_dir, f)).convert("RGB"),
                    np.float32) / 255.0)
    _TEX_BANK = bank
    return bank


def _sample_texture_img(img: np.ndarray, x: np.ndarray, y: np.ndarray,
                        scale: float) -> np.ndarray:
    """Planar-projected (world xy → uv, wrapping) bilinear image lookup."""
    H, W, _ = img.shape
    u = (x * scale) % 1.0 * (W - 1)
    v = (y * scale) % 1.0 * (H - 1)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u1 = np.minimum(u0 + 1, W - 1)
    v1 = np.minimum(v0 + 1, H - 1)
    return (img[v0, u0] * (1 - fv) * (1 - fu) + img[v0, u1] * (1 - fv) * fu
            + img[v1, u0] * fv * (1 - fu) + img[v1, u1] * fv * fu)


def _value_noise(x: np.ndarray, y: np.ndarray, seed: int, scale: float
                 ) -> np.ndarray:
    """Smoothed lattice value noise in [0,1] (procedural texture base)."""
    xs, ys = x * scale, y * scale
    xi, yi = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
    xf, yf = xs - xi, ys - yi

    def h(ix, iy):
        v = (ix * 374761393 + iy * 668265263 + seed * 1442695041) & 0x7fffffff
        v = (v ^ (v >> 13)) * 1274126177 & 0x7fffffff
        return (v & 0xffff) / 65535.0

    u = xf * xf * (3 - 2 * xf)
    v = yf * yf * (3 - 2 * yf)
    a = h(xi, yi) * (1 - u) + h(xi + 1, yi) * u
    b = h(xi, yi + 1) * (1 - u) + h(xi + 1, yi + 1) * u
    return a * (1 - v) + b * v


class DomainRandomizer:
    """Per-scene randomized materials + lights + floor texture
    (ref rd/render.py:10-18 per-scene seeding, :169-234 material binding)."""

    def __init__(self, rng: Optional[np.random.RandomState] = None):
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.materials: list = []
        self.lights: list = []
        self.floor: dict = {}
        self.texture_seed = 0
        self.ambient = 0.25  # overwritten by init_scene

    # ------------------------------------------------------------ sampling
    def _sample_material(self, ob) -> dict:
        rng = self.rng
        cls = MATERIAL_CLASSES[ob.material % len(MATERIAL_CLASSES)]
        spec, shin, metal, (lo, hi) = _CLASS_PARAMS[cls]
        albedo = rng.uniform(lo, hi, 3).astype(np.float32)
        if cls == "glass":
            # near-white transmission tint, occasional colored glass
            albedo = np.clip(albedo + rng.uniform(0.0, 0.3), 0.0, 1.0)
        tex_amp, tex_scale = _CLASS_TEXTURE.get(cls, (0.0, 1.0))
        mat = {
            "class": cls, "albedo": albedo,
            "spec": spec * rng.uniform(0.7, 1.3),
            "shin": shin * rng.uniform(0.7, 1.3),
            "metal": metal,
            # glass: Fresnel reflection + transmission (one bounce)
            "transmit": (rng.uniform(0.75, 0.95) if cls == "glass" else 0.0),
            "tex_amp": tex_amp * rng.uniform(0.6, 1.4) if tex_amp else 0.0,
            "tex_scale": tex_scale,
        }
        # image-based albedo (ref binds ImageNet crops to objects,
        # rd/render.py:169-213): planar-projected texture image modulates
        # the sampled base color
        bank = load_texture_bank()
        if bank and cls in _IMAGE_TEXTURE_CLASSES and rng.rand() < 0.5:
            mat["tex_img"] = int(rng.randint(0, len(bank)))
            mat["tex_img_scale"] = float(rng.uniform(4.0, 30.0))
        return mat

    def init_scene(self, scene: PrimScene):
        """Sample materials for every object + the table and the light rig.

        Materials are bound to object *identity* (stored on the PrimObject, as
        the reference binds Blender materials to object UIDs —
        rd/render.py:238-251) so removing an object never re-shuffles the
        survivors' appearance across closed-loop rounds."""
        rng = self.rng
        self.materials = []
        for ob in scene.objects:
            mat = self._sample_material(ob)
            ob._dr_material = mat
            self.materials.append(mat)
        # table/floor material (ref rd/render.py:215-234)
        base = rng.uniform(0.25, 0.8)
        tint = rng.uniform(0.85, 1.0, 3)
        self.floor = {
            "albedo": (base * tint).astype(np.float32),
            "spec": rng.uniform(0.0, 0.3), "shin": rng.uniform(4, 24),
            "tex_scale": rng.uniform(15.0, 80.0),
            "tex_amp": rng.uniform(0.05, 0.35),
        }
        self.texture_seed = int(rng.randint(1, 2 ** 31 - 1))
        # 1-3 lights: direction on the upper hemisphere, warm/cool color
        n_lights = rng.randint(1, 4)
        self.lights = []
        for _ in range(n_lights):
            az = rng.uniform(0, 2 * np.pi)
            el = rng.uniform(np.deg2rad(25), np.deg2rad(80))
            d = np.array([np.cos(az) * np.cos(el), np.sin(az) * np.cos(el),
                          np.sin(el)], np.float32)
            temp = rng.uniform(-0.1, 0.1)
            color = np.clip(np.array([1 + temp, 1.0, 1 - temp]), 0, None)
            self.lights.append({
                "dir": d, "color": (color * rng.uniform(0.5, 1.1)
                                    / n_lights).astype(np.float32)})
        self.ambient = rng.uniform(0.15, 0.4)
        # environment lighting: a randomized horizon->zenith sky gradient
        # (the procedural analog of the reference's HDRI env maps,
        # ref rd/render_utils.py env-map lighting / rd/render.py:20-110) —
        # miss rays see it, and the ambient term samples it at the normal
        base_h = rng.uniform(0.25, 0.75, 3)
        base_z = rng.uniform(0.2, 0.9, 3)
        self.env = {
            "horizon": base_h.astype(np.float32),
            "zenith": base_z.astype(np.float32),
            "strength": float(rng.uniform(0.6, 1.2)),
        }
        # image-based env lighting: sample one of the committed equirect maps
        # (assets/envmaps; ref HDRI world lighting rd/render.py:20-110) for
        # most scenes, keep the analytic sky gradient for the rest
        env_bank = load_env_bank()
        self.env_map = None
        if env_bank and rng.rand() < 0.7:
            img = env_bank[rng.randint(0, len(env_bank))]
            self.env_map = EnvMap(img, strength=float(rng.uniform(0.6, 1.3)))
        # floor can bind an image texture too (ref real floor/table photos,
        # rd/render.py:215-234)
        tex_bank = load_texture_bank()
        if tex_bank and rng.rand() < 0.5:
            self.floor["tex_img"] = int(rng.randint(0, len(tex_bank)))
            self.floor["tex_img_scale"] = float(rng.uniform(2.0, 12.0))
        return self

    def env_color(self, dirs: np.ndarray) -> np.ndarray:
        """Environment radiance for world directions [N,3]: the scene's
        equirect image map when bound, else the horizon->zenith gradient
        dimmed below the horizon."""
        if getattr(self, "env_map", None) is not None:
            return self.env_map.sample(dirs)
        z = np.clip(dirs[..., 2:3], -1.0, 1.0)
        t = 0.5 * (z + 1.0)
        c = (self.env["horizon"][None] * (1 - t) + self.env["zenith"][None] * t)
        below = np.clip(-z, 0.0, 1.0)
        return (c * self.env["strength"] * (1.0 - 0.7 * below)).astype(
            np.float32)

    def update_sceneobj(self, scene: PrimScene):
        """Re-sync materials after objects were removed or added
        (ref rd/render.py:238-251). Materials follow object identity: each
        survivor keeps the material stored on it; new objects get a fresh
        sample."""
        mats = []
        for ob in scene.objects:
            mat = getattr(ob, "_dr_material", None)
            if mat is None:
                mat = self._sample_material(ob)
                ob._dr_material = mat
            mats.append(mat)
        self.materials = mats

    # ------------------------------------------------------------- shading
    def shade(self, scene: PrimScene, points, normals, ids, miss_value=0.05):
        """Blinn-Phong with shadow rays at hit `points` [N,3]."""
        N = len(points)
        table_id = scene.table_id
        hit = ids >= 0
        is_table = ids == table_id

        albedo = np.full((N, 3), miss_value, np.float32)
        spec = np.zeros(N, np.float32)
        shin = np.ones(N, np.float32)
        metal = np.zeros(N, np.float32)
        transmit = np.zeros(N, np.float32)
        for i, m in enumerate(self.materials[:len(scene.objects)]):
            sel = ids == i
            albedo[sel] = m["albedo"]
            spec[sel] = m["spec"]
            shin[sel] = m["shin"]
            metal[sel] = m["metal"]
            transmit[sel] = m.get("transmit", 0.0)
            amp = m.get("tex_amp", 0.0)
            if sel.any() and m.get("tex_img") is not None:
                # image-based albedo: planar-projected texture image
                p = points[sel]
                img = load_texture_bank()[m["tex_img"]]
                tex = _sample_texture_img(img, p[:, 0] + 0.3 * p[:, 2],
                                          p[:, 1] - 0.3 * p[:, 2],
                                          m["tex_img_scale"])
                albedo[sel] = (0.35 * albedo[sel] + 0.65 * albedo[sel] * tex
                               * 2.0).astype(np.float32)
            elif amp and sel.any():
                # surface-varying procedural texture (leather grain / weave /
                # wood rings analog of the ref's node textures)
                p = points[sel]
                tex = _value_noise(p[:, 0] + p[:, 2], p[:, 1] - p[:, 2],
                                   self.texture_seed + i + 1,
                                   m["tex_scale"])
                albedo[sel] *= (1.0 + amp * (2 * tex - 1))[:, None].astype(
                    np.float32)
        if is_table.any():
            f = self.floor
            if f.get("tex_img") is not None:
                img = load_texture_bank()[f["tex_img"]]
                tex3 = _sample_texture_img(img, points[is_table, 0],
                                           points[is_table, 1],
                                           f["tex_img_scale"])
                albedo[is_table] = (f["albedo"][None] * tex3 * 2.0).astype(
                    np.float32)
            else:
                tex = _value_noise(points[is_table, 0], points[is_table, 1],
                                   self.texture_seed, f["tex_scale"])
                tex = 1.0 + f["tex_amp"] * (2 * tex - 1)
                albedo[is_table] = f["albedo"][None] * tex[:, None].astype(
                    np.float32)
            spec[is_table] = f["spec"]
            shin[is_table] = f["shin"]

        # hemispheric ambient: the sky gradient sampled at the normal
        if getattr(self, "env", None):
            rgb = albedo * self.ambient * self.env_color(normals)
        else:
            rgb = albedo * self.ambient
        for light in self.lights:
            ldir = light["dir"]
            lam = np.clip(normals @ ldir, 0.0, None)
            # shadow ray (objects only — lights are above the table)
            shadow = np.ones(N, np.float32)
            if hit.any() and len(scene.objects) > 0:
                o = points[hit] + normals[hit] * 1e-4
                d = np.tile(ldir[None], (int(hit.sum()), 1))
                t, _, sid = scene.trace(o, d, with_table=False)
                shadow_hit = np.isfinite(t)
                s = np.ones(int(hit.sum()), np.float32)
                s[shadow_hit] = 0.25
                shadow[hit] = s
            diffuse = albedo * (lam * shadow)[:, None]
            rgb = rgb + diffuse * light["color"][None]
        return np.clip(rgb, 0.0, 1.0), spec, shin, metal, transmit


def _shade_full(scene, pts, n, unit, oid, randomizer):
    """Blinn-Phong shade + specular highlights for a batch of hits.
    Returns (rgb, transmit)."""
    rgb, spec, shin, metal, transmit = randomizer.shade(scene, pts, n, oid)
    view = -unit
    for light in randomizer.lights:
        half = light["dir"][None] + view
        half /= np.linalg.norm(half, axis=-1, keepdims=True) + 1e-9
        nh = np.clip(np.sum(n * half, -1), 0.0, None)
        s = spec * nh ** np.maximum(shin, 1.0)
        tint = (1 - metal)[:, None] + metal[:, None] * rgb
        rgb = rgb + (s[:, None] * tint) * light["color"][None]
    return rgb, transmit


def render_scene(scene: PrimScene, pose: np.ndarray, K: np.ndarray,
                 h: int, w: int, randomizer: Optional[DomainRandomizer] = None,
                 return_normal: bool = False):
    """Render one view. Returns (rgb [h,w,3] in [0,1], z-depth [h,w]
    (0 = miss), fg_mask [h,w]) — plus world normals [h,w,3] when
    return_normal (ref rd/render.py:254-332 Normal pass). pose = world->cam
    [3,4].

    Glass objects (material class 'glass') get one secondary bounce:
    Schlick-Fresnel-weighted mirror reflection + tinted straight-through
    transmission (thin-glass approximation), both traced against the scene
    with environment fallback — the tracer analog of the reference's Cycles
    glass BSDF (ref rd/modify_material.py:1490-1598)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    Kinv = np.linalg.inv(K)
    cam_dirs = pix @ Kinv.T
    R, t = pose[:3, :3], pose[:3, 3]
    eye = -R.T @ t
    world_dirs = cam_dirs @ R
    unit = (world_dirs / np.linalg.norm(world_dirs, axis=-1, keepdims=True)
            ).astype(np.float32)
    origins = np.broadcast_to(eye.astype(np.float32), unit.shape)

    tt, n, oid = scene.trace(origins, unit)
    hit = np.isfinite(tt)
    pts = origins + unit * np.where(hit, tt, 0.0)[:, None]

    if randomizer is None:
        # flat Lambert fallback (same look as data.synthetic.Scene.render)
        light = np.array([0.3, -0.5, 0.8])
        light /= np.linalg.norm(light)
        lam = np.clip(n @ light, 0.0, 1.0) * 0.7 + 0.3
        palette = _default_palette(len(scene.objects) + 1)
        base = palette[np.clip(oid, 0, len(palette) - 1)]
        rgb = np.where(hit[:, None], base * lam[:, None], 0.05)
    else:
        rgb, transmit = _shade_full(scene, pts, n, unit, oid, randomizer)
        has_env = getattr(randomizer, "env", None)
        miss_rgb = (randomizer.env_color(unit) if has_env
                    else np.full_like(rgb, 0.05))

        glass = hit & (transmit > 0.0)
        if glass.any():
            gi = np.flatnonzero(glass)
            gn, gd, gp = n[gi], unit[gi], pts[gi]
            cos = np.clip(-np.sum(gn * gd, -1), 0.0, 1.0)
            fres = 0.04 + 0.96 * (1.0 - cos) ** 5        # Schlick, ior~1.5

            def bounce(o, d):
                t2, n2, oid2 = scene.trace(o, d)
                hit2 = np.isfinite(t2)
                p2 = o + d * np.where(hit2, t2, 0.0)[:, None]
                c2, _ = _shade_full(scene, p2, n2, d, oid2, randomizer)
                env2 = (randomizer.env_color(d) if has_env
                        else np.full_like(c2, 0.05))
                return np.where(hit2[:, None], c2, env2)

            refl_d = gd - 2.0 * np.sum(gd * gn, -1, keepdims=True) * gn
            refl = bounce(gp + gn * 1e-4, refl_d)
            # thin-glass transmission: continue straight through the body
            # (re-entry offset past the far surface along the ray)
            t_exit, _, _ = scene.trace(gp + gd * 1e-4, gd)
            step = np.where(np.isfinite(t_exit), t_exit + 1e-4, 1e-4)
            trans = bounce(gp + gd * (step + 1e-4)[:, None], gd)
            tint = np.stack([randomizer.materials[i]["albedo"]
                             if 0 <= i < len(randomizer.materials)
                             else np.ones(3, np.float32)
                             for i in oid[gi]])
            glass_rgb = (fres[:, None] * refl
                         + ((1 - fres) * transmit[gi])[:, None] * tint * trans
                         + ((1 - fres) * (1 - transmit[gi]))[:, None]
                         * rgb[gi])
            rgb[gi] = glass_rgb
        rgb = np.clip(np.where(hit[:, None], rgb, miss_rgb), 0.0, 1.0)

    zdepth = np.where(hit, tt * (unit @ R[2]), 0.0)
    fg = hit & (oid >= 0) & (oid < len(scene.objects))
    out = (rgb.reshape(h, w, 3).astype(np.float32),
           zdepth.reshape(h, w).astype(np.float32), fg.reshape(h, w))
    if return_normal:
        nm = np.where(hit[:, None], n, 0.0).reshape(h, w, 3)
        return out + (nm.astype(np.float32),)
    return out


def render_ir_stereo(scene: PrimScene, pose: np.ndarray, K: np.ndarray,
                     h: int, w: int,
                     randomizer: Optional[DomainRandomizer] = None,
                     baseline: float = 0.055):
    """Active IR stereo pair (ref rd/render.py:254-332 stereo branch +
    data_generator/render_pile_STD_rand.py IR option): two grayscale views
    from cameras offset ±baseline/2 along the camera x axis, lit by a
    dot-speckle projector co-located with the center camera plus a faint
    ambient term. Returns (ir_left [h,w], ir_right [h,w]) in [0,1].

    pose = world->cam [3,4] of the CENTER (RGB) camera; the projector sits at
    its optical center, so the speckle pattern is fixed in the center-camera
    image plane — the geometry real RGB-D sensors have."""
    R, t = pose[:3, :3], pose[:3, 3]
    proj_eye = (-R.T @ t).astype(np.float32)
    seed = randomizer.texture_seed if randomizer is not None else 1234

    out = []
    for side in (-1.0, 1.0):
        p = pose.copy()
        p[:3, 3] = t - np.array([side * baseline / 2, 0.0, 0.0], np.float32)
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
        cam_dirs = pix @ np.linalg.inv(K).T
        world_dirs = cam_dirs @ p[:3, :3]
        unit = (world_dirs
                / np.linalg.norm(world_dirs, axis=-1, keepdims=True)
                ).astype(np.float32)
        eye = (-p[:3, :3].T @ p[:3, 3]).astype(np.float32)
        origins = np.broadcast_to(eye, unit.shape)
        tt, n, oid = scene.trace(origins, unit)
        hit = np.isfinite(tt)
        pts = origins + unit * np.where(hit, tt, 0.0)[:, None]

        # reflectivity ~ luma of the diffuse albedo
        if randomizer is not None:
            alb, _, _, _, _ = randomizer.shade(scene, pts, n, oid)
            refl = alb @ np.array([0.299, 0.587, 0.114], np.float32)
        else:
            refl = np.full(len(pts), 0.5, np.float32)

        # projector: speckle keyed to the CENTER camera pixel of each point
        to_proj = proj_eye[None] - pts
        dist = np.linalg.norm(to_proj, axis=-1)
        ldir = to_proj / (dist[:, None] + 1e-9)
        lam = np.clip(np.sum(n * ldir, -1), 0.0, None)
        cam_pts = pts @ R.T + t[None]
        z = np.maximum(cam_pts[:, 2], 1e-6)
        uv = (cam_pts @ K.T) / z[:, None]
        speck = _value_noise(uv[:, 0] / w, uv[:, 1] / h, seed, 180.0)
        dots = (speck > 0.72).astype(np.float32)
        # projector shadow: occlusion between surface point and projector
        vis = np.ones(len(pts), np.float32)
        if hit.any():
            hi = np.flatnonzero(hit)
            t2, _, _ = scene.trace(pts[hi] + n[hi] * 1e-4, ldir[hi])
            vis[hi] = np.where(np.isfinite(t2) & (t2 < dist[hi] - 1e-3),
                               0.0, 1.0)
        ir = refl * (0.12 + 2.2 * dots * lam * vis
                     / np.maximum(dist, 0.2) ** 2 * 0.25)
        ir = np.where(hit, ir, 0.02)
        out.append(np.clip(ir, 0.0, 1.0).reshape(h, w).astype(np.float32))
    return out[0], out[1]


def _default_palette(n: int) -> np.ndarray:
    rng = np.random.RandomState(7)
    return rng.uniform(0.2, 0.9, (max(n, 1), 3)).astype(np.float32)


def render_views_to_dir(scene: PrimScene, poses: np.ndarray, K: np.ndarray,
                        h: int, w: int, outdir: str,
                        randomizer: Optional[DomainRandomizer] = None,
                        frame_ids=None, write_depth: bool = False,
                        write_mask: bool = False,
                        write_normal: bool = False,
                        write_ir: bool = False, ir_baseline: float = 0.055):
    """Write the reference's file contract (ref rd/render.py:254-332 +
    dataset/database.py:110-111): rgb/%04d.png for each frame id +
    camera_pose.npy [V,4,4] world->cam for ALL poses; optional depth/mask/
    normal passes (the reference's DEPTH_EXR / mask / Normal outputs).
    PNGs through PIL where it imports, else PIL's bytes from
    `data.png.write_png`."""
    os.makedirs(os.path.join(outdir, "rgb"), exist_ok=True)
    for flag, sub in ((write_depth, "depth"), (write_mask, "mask"),
                      (write_normal, "normal"), (write_ir, "ir_l"),
                      (write_ir, "ir_r")):
        if flag:
            os.makedirs(os.path.join(outdir, sub), exist_ok=True)
    frame_ids = (list(range(len(poses))) if frame_ids is None
                 else list(frame_ids))
    from ..data.exr import write_exr
    from ..data.png import save_png
    for fid in frame_ids:
        rgb, depth, fg, nm = render_scene(scene, poses[fid], K, h, w,
                                          randomizer, return_normal=True)
        save_png(os.path.join(outdir, "rgb", f"{fid:04d}.png"),
                 (rgb * 255).astype(np.uint8))
        if write_depth:  # reference DEPTH_EXR pass (rd/render_utils.py:585)
            write_exr(os.path.join(outdir, "depth", f"{fid:04d}.exr"),
                      depth.astype(np.float32))
        if write_mask:
            write_exr(os.path.join(outdir, "mask", f"{fid:04d}.exr"),
                      fg.astype(np.float32))
        if write_normal:
            np.save(os.path.join(outdir, "normal", f"{fid:04d}.npy"), nm)
        if write_ir:  # active-IR stereo pair (ref stereo/IR render branch)
            irl, irr = render_ir_stereo(scene, poses[fid], K, h, w,
                                        randomizer, ir_baseline)
            for name, im in (("ir_l", irl), ("ir_r", irr)):
                save_png(os.path.join(outdir, name, f"{fid:04d}.png"),
                         (im * 255).astype(np.uint8))
    # camera_pose.npy follows the reference contract: cam->world matrices in
    # Blender camera axes (ref dataset/database.py:110-111, the loader
    # computes world->cam = inv(pose @ BLENDER2OPENCV))
    from ..data.database import BLENDER2OPENCV
    exts = np.tile(np.eye(4, dtype=np.float32)[None], (len(poses), 1, 1))
    exts[:, :3, :] = poses
    cams = np.linalg.inv(exts) @ BLENDER2OPENCV[None]
    np.save(os.path.join(outdir, "camera_pose.npy"), cams.astype(np.float32))
    return outdir
