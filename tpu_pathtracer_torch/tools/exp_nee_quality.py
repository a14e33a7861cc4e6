"""NEE policy evidence: is --nee a *win per second*?

NEE's cost (a shadow ray and an alias-table light draw a surface hit) is
only half of the question; the other half is what it buys.  This
experiment measures both halves on the port's own renders:

  * VARIANCE at equal sample count (hardware-independent): per-pixel MSE
    of k-spp estimates against a converged mean, averaged over the frame.
    NEE's per-sample variance reduction factor r = Var_bsdf / Var_nee.
  * EQUAL-TIME verdict: with measured wall costs t_nee/t_bsdf per sample,
    NEE wins iff r > t_nee/t_bsdf (variance of an n-sample mean is
    Var_1/n, so quality per second is Var_1 * t per sample — smaller
    wins).  Without --timed the cost ratio is --cost-ratio (1.60 by
    default, the JAX tool's assumed ratio, not a measurement of any card);
    with --timed it is the best frame's seconds of each arm (render_frame
    and the copy to the host, which waits for the card; frame 0, which
    builds the kernels and captures the loop's graph, left out).
  * SSIM at equal time on the displayed (tonemapped) image, the
    user-visible check at small spp budgets, and with --denoised the same
    through the A-Trous denoiser.

Scenes: three-spheres under the procedural HDR (bright sun blob — the
case importance sampling exists for), rendered by brute force (on the
card the brute-force kernels, csrc/brute.cu); the
textured monkey and the suitcase hero read the reference renderer's OBJs
from --reference DIR and are refused, naming the file, where it is absent.
Counterpart of the repository's `tools/exp_nee_quality.py`: the same flags
and defaults, JSON line and arithmetic, plus --device and --reference (the
JAX tool reads the OBJs from a fixed directory).

Usage (CPU):  python -m tpu_pathtracer_torch.tools.exp_nee_quality --device cpu --size 32x24 --frames 4 --spp 1
Usage (card): python -m tpu_pathtracer_torch.tools.exp_nee_quality --timed [--defensive] [--mis] [--denoised]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpu_pathtracer_torch.config import RenderConfig
from tpu_pathtracer_torch.render.aov import atrous_denoise, render_aov
from tpu_pathtracer_torch.render.camera import Camera, camera_arrays
from tpu_pathtracer_torch.render.envmap import with_importance_sampling
from tpu_pathtracer_torch.render.film import post_process, to_uint8
from tpu_pathtracer_torch.render.integrator import render_frame
from tpu_pathtracer_torch.scene.scene import make_env
from tpu_pathtracer_torch.utils.device import resolve
from tpu_pathtracer_torch.utils.image import procedural_hdr
from tpu_pathtracer_torch.utils.ssim import ssim

# The reference renderer's OBJs each OBJ scene reads.
SCENE_FILES = {"monkey": ["monkey.obj"], "suitcase": ["suitcase.obj", "test.obj"]}


def scene_files(scene_name: str, reference) -> list:
    """The paths of the OBJs `scene_name` reads from the directory
    `reference`; exits, naming the first file that is absent."""
    paths = []
    for name in SCENE_FILES.get(scene_name, ()):
        if reference is None:
            raise SystemExit(f"exp_nee_quality: --scene {scene_name} needs the reference renderer's {name}: "
                             "pass --reference DIR")
        path = os.path.join(reference, name)
        if not os.path.exists(path):
            raise SystemExit(f"exp_nee_quality: --scene {scene_name} needs {path}, which is absent")
        paths.append(path)
    return paths


def build(scene_name: str, nee, size, device, reference=None):
    """(scene, camera arrays, cfg) of one arm on `device`: `nee` False for
    the BSDF arm, True for NEE, or "defensive", "mis" or "defensive+mis"
    for NEE with those options; the OBJ scenes read `reference`."""
    files = scene_files(scene_name, reference)
    env = make_env(procedural_hdr(128, 256), device)
    if nee:
        env = with_importance_sampling(env)
    w, h = size
    nee_opts = set(nee.split("+")) if isinstance(nee, str) else set()
    common = dict(
        width=w, height=h, samples_per_launch=1, dof=False,
        env_mode="equirect", env_importance_sampling=bool(nee),
        nee_defensive_mix="defensive" in nee_opts,
        nee_mis_spec="mis" in nee_opts,
        rr_mode="standard",   # SAME estimator both arms: isolate NEE
    )
    if scene_name == "spheres":
        from tpu_pathtracer_torch.scene.procedural import three_spheres_scene

        scene = three_spheres_scene(device=device).replace(env=env)
        cfg = RenderConfig(max_depth=6, intersector="brute", **common)
        cam = Camera(eye=(0, 2, 8), lookat=(0, 1, 0))
    elif scene_name == "monkey":
        from tpu_pathtracer_torch.scene.cache import load_scene_cached

        scene = load_scene_cached(files, env=env, accel="cluster", device=device)
        cfg = RenderConfig(max_depth=6, intersector="cluster", **common)
        cam = Camera(eye=(0, 1, 4), lookat=(0, 0.6, 0))
    elif scene_name == "suitcase":
        from tpu_pathtracer_torch.scene.cache import load_scene_cached

        scene = load_scene_cached(files, scale=0.05, env=env, accel="cluster", device=device)
        cfg = RenderConfig(max_depth=8, intersector="cluster", **common)
        cam = Camera(eye=(0, 2, 6), lookat=(0, 0.5, 0))
    else:
        raise SystemExit(f"unknown scene {scene_name}")
    return scene, camera_arrays(cam.with_aspect(w, h), cfg, device), cfg


def run_arm(scene_name, nee, size, n_frames, timed, device, reference=None):
    """Render n 1-spp frames; return (frames [N,H,W,3], sec_per_frame, cfg):
    the best frame's seconds after frame 0, NaN unless `timed`."""
    scene, cam, cfg = build(scene_name, nee, size, device, reference)
    frames = []
    t_best = float("inf")
    for k in range(n_frames):
        t0 = time.perf_counter()
        f = render_frame(scene, cam, cfg, k)
        host = f.cpu().numpy()    # the copy waits for the card
        dt = time.perf_counter() - t0
        if k > 0:                 # frame 0 builds the kernels and captures the loop
            t_best = min(t_best, dt)
        frames.append(host)
    if not timed:
        t_best = float("nan")
    return np.stack(frames), t_best, cfg


def luminance(img):
    return img @ np.array([0.2126, 0.7152, 0.0722], np.float32)


def report(args, f_off, f_nee, t_off, t_nee, cfg) -> dict:
    """The JSON line's fields from both arms' frames and seconds."""
    w, h = (int(v) for v in args.size.split("x"))
    dev = resolve(args.device)

    # Converged target: mean of BOTH arms' frames (2N spp total; both
    # estimators are unbiased for the same integral).
    target = (f_off.mean(axis=0) + f_nee.mean(axis=0)) / 2.0

    def var_of(frames):
        d = luminance(frames) - luminance(target)[None]
        return float(np.mean(d * d))

    v_off, v_nee = var_of(f_off), var_of(f_nee)
    r = v_off / v_nee
    cost = (t_nee / t_off) if args.timed else args.cost_ratio
    # quality/second metric: variance * time per sample (lower = better)
    eff = r / cost

    # Equal-time SSIM on the displayed image: give the BSDF arm `cost`x
    # the sample budget of the NEE arm (same wall clock).
    def shown(x):
        return to_uint8(post_process(torch.as_tensor(x, device=dev), cfg)).cpu().numpy() / 255.0

    img_ref = shown(target)

    # Displayed-image check across budgets: the tonemap clamps BSDF-arm
    # fireflies (rare bright env hits), so the linear-variance verdict and
    # the small-budget display verdict can disagree — sweep to see where
    # they cross.
    ssim_table = {}
    budgets = sorted({args.spp, 1, 2, 4, 8, 16})
    for b in budgets:
        n_off_b = max(1, int(round(b * cost)))
        if b > len(f_nee) or n_off_b > len(f_off):
            continue
        s_o = ssim(shown(f_off[:n_off_b].mean(axis=0)), img_ref)
        s_n = ssim(shown(f_nee[:b].mean(axis=0)), img_ref)
        ssim_table[f"nee@{b}spp_vs_bsdf@{n_off_b}spp"] = [
            round(float(s_n), 5), round(float(s_o), 5)
        ]
    # Same sweep through the built-in denoiser: the recommended low-spp
    # workflow clamps fireflies BEFORE filtering, so the tonemap-clamp
    # advantage of the BSDF arm may not survive.  One deterministic
    # G-buffer serves both arms (estimator-independent geometry pass).
    denoised_table = {}
    if args.denoised:
        scene_d, cam_d, cfg_d = build(args.scene, False, (w, h), dev, args.reference)
        aov = render_aov(scene_d, cam_d, cfg_d)

        def shown_dn(x):
            den = atrous_denoise(torch.as_tensor(x, device=dev), aov)
            return to_uint8(post_process(den, cfg)).cpu().numpy() / 255.0

        ref_dn = shown(target)  # judge against the converged RAW display
        for b in budgets:
            n_off_b = max(1, int(round(b * cost)))
            if b > len(f_nee) or n_off_b > len(f_off):
                continue
            s_o = ssim(shown_dn(f_off[:n_off_b].mean(axis=0)), ref_dn)
            s_n = ssim(shown_dn(f_nee[:b].mean(axis=0)), ref_dn)
            denoised_table[f"nee@{b}spp_vs_bsdf@{n_off_b}spp"] = [
                round(float(s_n), 5), round(float(s_o), 5)
            ]

    n_nee = args.spp
    n_off = max(1, int(round(args.spp * cost)))
    s_off = ssim(shown(f_off[:n_off].mean(axis=0)), img_ref)
    s_nee = ssim(shown(f_nee[:n_nee].mean(axis=0)), img_ref)

    return {
        "scene": args.scene, "size": args.size, "frames": args.frames,
        "nee_defensive_mix": args.defensive,
        "nee_mis_spec": args.mis,
        "var_bsdf_1spp": v_off, "var_nee_1spp": v_nee,
        "variance_reduction": round(r, 3),
        "cost_ratio": round(cost, 3),
        "timed": args.timed,
        "sec_per_frame": {"bsdf": t_off, "nee": t_nee},
        "equal_time_efficiency": round(eff, 3),
        "nee_wins_equal_time": bool(eff > 1.0),
        "equal_time_ssim": {
            f"bsdf@{n_off}spp": round(float(s_off), 5),
            f"nee@{n_nee}spp": round(float(s_nee), 5),
        },
        "equal_time_ssim_sweep": ssim_table,
        **({"equal_time_ssim_denoised": denoised_table} if denoised_table else {}),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m tpu_pathtracer_torch.tools.exp_nee_quality")
    ap.add_argument("--scene", default="spheres",
                    choices=["spheres", "monkey", "suitcase"])
    ap.add_argument("--size", default="160x120")
    ap.add_argument("--frames", type=int, default=48,
                    help="1-spp frames per arm (variance + converged mean)")
    ap.add_argument("--spp", type=int, default=3,
                    help="budget for the equal-time SSIM check")
    ap.add_argument("--timed", action="store_true",
                    help="use each arm's measured seconds a frame (on the card); "
                    "otherwise substitute --cost-ratio")
    ap.add_argument("--cost-ratio", type=float, default=1.60,
                    help="t_nee/t_bsdf when not --timed: 1.60 is the JAX tool's "
                    "assumed ratio, not a measurement of any card")
    ap.add_argument("--defensive", action="store_true",
                    help="the NEE arm uses the 0.5 alias + 0.5 cosine "
                    "defensive mixture (cfg.nee_defensive_mix)")
    ap.add_argument("--mis", action="store_true",
                    help="the NEE arm uses spec-lobe MIS "
                    "(cfg.nee_mis_spec); combinable with --defensive")
    ap.add_argument("--denoised", action="store_true",
                    help="additionally sweep display SSIM through the "
                    "built-in A-Trous denoiser (the recommended low-spp "
                    "workflow): does --nee win once fireflies are "
                    "clamp+filtered instead of tonemap-clamped?")
    ap.add_argument("--save-frames", default="",
                    help="npz path to dump both arms' frames for reuse")
    ap.add_argument("--device", default="cuda", help="torch device to render on (cuda, cuda:N or cpu)")
    ap.add_argument("--reference", default=None,
                    help="directory of the reference renderer's OBJs (monkey.obj; suitcase.obj and test.obj): "
                    "--scene monkey and suitcase need it")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.size.split("x"))
    device = resolve(args.device)

    opts = [o for o, on in (("defensive", args.defensive), ("mis", args.mis)) if on]
    nee_mode = "+".join(opts) if opts else True
    f_off, t_off, cfg = run_arm(args.scene, False, (w, h), args.frames, args.timed, device, args.reference)
    f_nee, t_nee, _ = run_arm(args.scene, nee_mode, (w, h), args.frames, args.timed, device, args.reference)
    if args.save_frames:
        np.savez_compressed(args.save_frames, bsdf=f_off, nee=f_nee)
    print(json.dumps(report(args, f_off, f_nee, t_off, t_nee, cfg)))


if __name__ == "__main__":
    main()
