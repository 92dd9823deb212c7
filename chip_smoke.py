"""Smoke test of the whole system on one NVIDIA GPU (or four, with an option).

    python chip_smoke.py               # one card: every single-card phase
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Drives the main paths through the entry points a user calls, at KITTI
scale (375×1242, D=192, k=15, β=50, threshold 0.6) on synthetic scenes
made from a seed, and the reference's all-pairs workload on the
checked-in 330×422 capture.  Each phase prints one line; every time is
printed beside the card's name and power limit.  The first failing phase
stops the run with a non-zero exit; the last line is a JSON object only
when every phase passed.  It refuses to run off a GPU.

Tolerances, with their reasons:

* fused kernel vs XLA path: the window sums are accumulated in another
  order (tensor-core float32 sums of exact TF32 parts vs XLA's
  reduce-window), and the soft-argmax sums are rescaled online; a hard
  disparity may differ only where the two best costs tie to within
  ``TIE`` in the XLA volume, on at most ``MAX_TIES`` of the pixels.
  As a control, the kernel at ``precision="default"`` (one TF32 pass,
  2⁻¹¹ relative per term) must fail these tolerances.
* XLA op vs golden oracle: the op uses the float32 moments identity
  ``s2 − s²/k²``, which cancels, while the oracle centres each window;
  GPU reduction order differs from the CPU's.  Contractions run at
  ``precision="highest"`` — on this card a float32 product would
  otherwise run in TF32.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

TIE = 1e-5            # cost gap below which two disparities tie
MAX_TIES = 1e-4       # share of pixels allowed to differ at such ties
SOFT_ATOL = 1e-3      # px, soft disparity, kernel vs XLA
CONF_ATOL = 1e-5      # confidence, kernel vs XLA
GOLD_RTOL, GOLD_ATOL = 5e-4, 5e-5     # volume vs golden
GRAD_RTOL, GRAD_ATOL = 1e-3, 5e-5     # gradient / max|gradient| vs golden

H, W, D, K = 375, 1242, 192, 15


def card() -> str:
    """The cards' name and power limit as nvidia-smi gives them (one line
    per card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


CARD = ""


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def timed(fn, *args, n: int = 20):
    """Median and min of ``n`` calls in ms, each ending in
    ``block_until_ready`` (after one warm call)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), min(ts)


def ms(t) -> str:
    return f"median {t[0]:.3f} ms, min {t[1]:.3f} ms ({CARD})"


def kitti_batch(B: int, seed: int = 0):
    from custereomatching_tpu.data import make_stereo_pair

    cams, projs, disps = zip(*(make_stereo_pair(
        H, W, d_min=5.0, d_max=150.0, noise=0.01, seed=seed + i)
        for i in range(B)))
    return np.stack(cams), np.stack(projs), np.stack(disps)


def map_errors(phase, got, want, cv):
    """Kernel maps vs XLA maps, ``cv`` the XLA volume: prints the
    differences and returns the tolerances they break (see the module
    docstring)."""
    gd, wd = np.asarray(got.disparity), np.asarray(want.disparity)
    diff = gd != wd
    n = int(diff.sum())
    gap = 0.0
    if n:
        a = np.take_along_axis(cv, gd[..., None].astype(int), -1)[..., 0]
        b = np.take_along_axis(cv, wd[..., None].astype(int), -1)[..., 0]
        gap = float(np.abs(a - b)[diff].max())
    soft = float(np.abs(np.asarray(got.soft_disparity)
                        - np.asarray(want.soft_disparity)).max())
    conf = float(np.abs(np.asarray(got.confidence)
                        - np.asarray(want.confidence)).max())
    say(phase, f"hard disparity differs at {n} of {gd.size} pixels, cost "
               f"gap {gap:.3g} (ties: gap {TIE:g}, share {MAX_TIES:g}); "
               f"soft max|d| {soft:.3g} px (atol {SOFT_ATOL:g}); "
               f"confidence max|d| {conf:.3g} (atol {CONF_ATOL:g})")
    broken = [(gap > TIE, f"hard disparity differs beyond a tie: {gap}"),
              (n > MAX_TIES * gd.size, f"{n} hard-disparity ties"),
              (soft > SOFT_ATOL, f"soft disparity off by {soft}"),
              (conf > CONF_ATOL, f"confidence off by {conf}")]
    return [msg for bad, msg in broken if bad]


def compare_maps(phase, got, want, cv):
    """Fails the phase unless the kernel maps meet every tolerance."""
    broken = map_errors(phase, got, want, cv)
    check(not broken, "; ".join(broken))


def accuracy(phase, maps, truth, min_coverage=0.5, max_epe=1.0):
    from custereomatching_tpu.utils import disparity_metrics

    m = disparity_metrics(np.asarray(maps.soft_disparity).ravel(),
                          truth.ravel(), np.asarray(maps.mask).ravel())
    m = {k: float(v) for k, v in m.items()}
    say(phase, f"vs ground truth: EPE {m['epe']:.3f} px, coverage "
               f"{m['coverage']:.3f}, bad3 {m['bad3']:.4f}")
    check(m["coverage"] >= min_coverage and m["epe"] <= max_epe,
          f"accuracy out of bounds: {m}")


def finite(phase, tree):
    import jax

    for x in jax.tree_util.tree_leaves(tree):
        check(np.all(np.isfinite(np.asarray(x))), f"{phase}: non-finite")


# ---------------------------------------------------------------------------
# Single-card phases
# ---------------------------------------------------------------------------

def phase_inference(cams, projs, truth):
    import jax
    import jax.numpy as jnp

    from custereomatching_tpu import StereoConfig, StereoMatcher
    from custereomatching_tpu.models import StereoEngine

    cfg = StereoConfig(kernel_size=K, num_disparities=D)
    check(cfg.resolved_backend() == "pallas", "auto backend is not pallas")
    eng = StereoEngine(cfg)
    t0 = time.perf_counter()
    eng.warmup()
    say("inference", f"StereoEngine.warmup() of buckets {eng.buckets}: "
                     f"{time.perf_counter() - t0:.1f} s ({CARD})")
    lat = []
    for i in range(3):
        t0 = time.perf_counter()
        out = eng.infer(cams[i], projs[i])
        lat.append((time.perf_counter() - t0) * 1e3)
        check(out.disparity.shape == (H, W), "engine output shape")
        finite("inference", out)
    say("inference", f"StereoEngine.infer numpy->numpy, 3 frames: "
                     f"{', '.join(f'{t:.3f}' for t in lat)} ms ({CARD})")
    accuracy("inference", out, truth[2])

    model = StereoMatcher(cfg)
    maps = jax.jit(model.disparity_maps)
    for B in (1, 4):
        c, p = jnp.asarray(cams[:B]), jnp.asarray(projs[:B])
        out = maps(c, p)
        check(out.disparity.shape == (B, H, W), "maps shape")
        finite("inference", out)
        say("inference", f"disparity_maps B={B}: {ms(timed(maps, c, p))}")
    accuracy("inference", out, truth[:4])


def phase_kernel_vs_xla(cams, projs):
    import jax
    import jax.numpy as jnp

    from custereomatching_tpu import StereoConfig, StereoMatcher

    kern = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D,
                                      backend="pallas"))
    xla = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D,
                                     backend="xla"))
    tf32 = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D,
                                      backend="pallas", precision="default"))
    f_k, f_x = jax.jit(kern.disparity_maps), jax.jit(xla.disparity_maps)
    f_v = jax.jit(xla.cost_volume)
    for B in (1, 4):
        c, p = jnp.asarray(cams[:B]), jnp.asarray(projs[:B])
        want, cv = f_x(c, p), np.asarray(f_v(c, p))
        compare_maps("kernel-vs-xla", f_k(c, p), want, cv)
        if B == 1:
            broken = map_errors("kernel-vs-xla TF32 control",
                                jax.jit(tf32.disparity_maps)(c, p), want, cv)
            check(broken, "a one-pass TF32 kernel met the parity tolerances")
            say("kernel-vs-xla TF32 control", f"rejected as it must be: "
                                              f"{'; '.join(broken)}")
        tk, tx = timed(f_k, c, p), timed(f_x, c, p)
        say("kernel-vs-xla", f"B={B} fused kernel {ms(tk)}")
        say("kernel-vs-xla", f"B={B} XLA volume+head {ms(tx)}; kernel/XLA "
                             f"median ratio {tk[0] / tx[0]:.3f}")


def _strips(h_out: int, reach: int):
    """Row strips (top, middle, bottom) of ``h_out`` output rows with the
    input rows within ``reach`` of them, clipped to the frame."""
    for r0 in (0, (H - h_out) // 2, H - h_out):
        a, b = max(r0 - reach, 0), min(r0 + h_out + reach, H)
        yield r0, a, b


def phase_volume(cams, projs):
    import jax
    import jax.numpy as jnp

    from custereomatching_tpu.ops import golden, stereo_matching

    c, p = jnp.asarray(cams[0]), jnp.asarray(projs[0])
    fwd = jax.jit(lambda c, p: stereo_matching(c, p, D, K))
    g = jax.random.normal(jax.random.PRNGKey(0), (H, W, D + 1), jnp.float32)
    grad = jax.jit(jax.grad(lambda c, p, g: jnp.sum(
        stereo_matching(c, p, D, K) * g)))
    cv = np.asarray(fwd(c, p))
    gc = np.asarray(grad(c, p, g))
    finite("volume", (cv, gc))
    say("volume", f"forward [{H},{W},{D + 1}]: {ms(timed(fwd, c, p))}")
    say("volume", f"forward+backward: {ms(timed(grad, c, p, g))}")

    pad = K // 2
    for r0, a, b in _strips(4, pad):
        want = np.asarray(golden.zncc_cost_volume(c[a:b], p[a:b], D, K))
        got = cv[r0:r0 + 4]
        err = float(np.abs(got - want[r0 - a:r0 - a + 4]).max())
        check(np.allclose(got, want[r0 - a:r0 - a + 4], GOLD_RTOL,
                          GOLD_ATOL), f"volume rows {r0}: max|d| {err}")
        say("volume", f"rows {r0}..{r0 + 3} vs golden: max|d| {err:.3g} "
                      f"(rtol {GOLD_RTOL:g}, atol {GOLD_ATOL:g})")
    for r0, a, b in _strips(2, 2 * pad):
        # The gradient at rows r0.. sees the cotangent within one
        # half-window of them and the images within two.
        gs = np.zeros((b - a, W, D + 1), np.float32)
        lo, hi = max(r0 - pad, 0), min(r0 + 2 + pad, H)
        gs[lo - a:hi - a] = np.asarray(g[lo:hi])
        want = np.asarray(golden.zncc_camera_grad(
            c[a:b], p[a:b], jnp.asarray(gs), D, K))[r0 - a:r0 - a + 2]
        got = gc[r0:r0 + 2]
        scale = float(np.abs(want).max()) + 1e-6
        err = float(np.abs(got - want).max()) / scale
        check(np.allclose(got / scale, want / scale, GRAD_RTOL, GRAD_ATOL),
              f"camera grad rows {r0}: max|d|/scale {err}")
        say("volume", f"camera grad rows {r0}..{r0 + 1} vs golden: "
                      f"max|d|/max|g| {err:.3g} (rtol {GRAD_RTOL:g}, "
                      f"atol {GRAD_ATOL:g})")


def phase_allpairs():
    import os

    import jax
    import jax.numpy as jnp

    from custereomatching_tpu.data.io import load_image_gray, png_decoder
    from custereomatching_tpu.ops import golden, stereo_matching

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "data")
    dec = png_decoder()
    say("all-pairs", f"PNG decoder: {dec}")
    check(dec is not None, "no PNG decoder for the checked-in capture")
    cam = jnp.asarray(load_image_gray(os.path.join(data, "capture_camera.png")))
    proj = jnp.asarray(load_image_gray(
        os.path.join(data, "capture_projector.png")))
    check(cam.shape == (330, 422), f"capture shape {cam.shape}")
    k = 15
    fwd = jax.jit(lambda c, p: stereo_matching(c, p, None, k))
    g = jax.random.normal(jax.random.PRNGKey(1), (330, 422, 422), jnp.float32)
    grad = jax.jit(jax.grad(lambda c, p, g: jnp.sum(
        stereo_matching(c, p, None, k) * g)))
    cv, gc = np.asarray(fwd(cam, proj)), np.asarray(grad(cam, proj, g))
    say("all-pairs", f"forward [330,422,422]: {ms(timed(fwd, cam, proj))}")
    say("all-pairs", f"forward+backward: {ms(timed(grad, cam, proj, g))}")
    want = np.asarray(golden.zncc_cost_volume(cam, proj, None, k))
    err = float(np.abs(cv - want).max())
    check(np.allclose(cv, want, GOLD_RTOL, GOLD_ATOL),
          f"all-pairs volume max|d| {err}")
    want_g = np.asarray(golden.zncc_camera_grad(cam, proj, g, None, k))
    scale = float(np.abs(want_g).max()) + 1e-6
    gerr = float(np.abs(gc - want_g).max()) / scale
    check(np.allclose(gc / scale, want_g / scale, GRAD_RTOL, GRAD_ATOL),
          f"all-pairs grad max|d|/scale {gerr}")
    say("all-pairs", f"vs golden at precision='highest' (true float32, not "
                     f"TF32): volume max|d| {err:.3g}, camera grad "
                     f"max|d|/max|g| {gerr:.3g}")


def phase_train(cams, projs):
    import jax
    import jax.numpy as jnp
    import optax

    from custereomatching_tpu import StereoConfig, StereoMatcher
    from custereomatching_tpu.models import init_state, make_train_step

    model = StereoMatcher(StereoConfig(kernel_size=K, num_disparities=D))
    cam_true, proj = jnp.asarray(cams[:1]), jnp.asarray(projs[:1])
    target = model.trainable_disparity_maps(cam_true, proj).soft_disparity
    noise = jax.random.normal(jax.random.PRNGKey(2), cam_true.shape)
    opt = optax.adam(1e-3)
    state = init_state(cam_true + 0.1 * noise, opt)
    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    state, m = step(state, proj, target)
    losses = [float(m.loss)]
    say("train", f"first step (compile): {time.perf_counter() - t0:.1f} s")
    for _ in range(4):
        state, m = step(state, proj, target)
        losses.append(float(m.loss))
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    say("train", f"losses {', '.join(f'{x:.4f}' for x in losses)}; step "
                 f"{ms(timed(step, state, proj, target, n=5))}")


def phase_pyramid_lr(cams, projs, truth):
    import jax
    import jax.numpy as jnp

    from custereomatching_tpu import StereoConfig, StereoMatcher
    from custereomatching_tpu.models import PyramidStereoMatcher

    cfg = StereoConfig(kernel_size=K, num_disparities=D)
    c, p = jnp.asarray(cams[:1]), jnp.asarray(projs[:1])
    pyr = jax.jit(PyramidStereoMatcher(cfg, downsample=4, residual=12))
    out = pyr(c, p)
    finite("pyramid", out)
    check(out.disparity.shape == (1, H, W), "pyramid shape")
    say("pyramid", f"one call: {ms(timed(pyr, c, p, n=5))}")
    accuracy("pyramid", out, truth[:1])
    lr = jax.jit(StereoMatcher(cfg).disparity_maps_lr)
    out = lr(c, p)
    finite("lr", out)
    check(out.disparity.shape == (1, H, W), "lr shape")
    say("lr", f"disparity_maps_lr one call: {ms(timed(lr, c, p, n=5))}")
    accuracy("lr", out, truth[:1])


# ---------------------------------------------------------------------------
# Four-card phases
# ---------------------------------------------------------------------------

def phase_halo():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from custereomatching_tpu.config import MeshConfig
    from custereomatching_tpu.parallel import halo_exchange, make_mesh

    mesh = make_mesh(MeshConfig(data=1, space=4))
    halo, rows = K // 2, 94
    x = jnp.arange(4 * rows * 8, dtype=jnp.float32).reshape(1, 4 * rows, 8)
    spec = P("data", "space", None)
    out = np.asarray(jax.shard_map(
        lambda b: halo_exchange(b, halo, "space", axis=1), mesh=mesh,
        in_specs=spec, out_specs=spec)(x))
    z = np.zeros((halo, 8), np.float32)
    padded = np.concatenate([z, np.asarray(x[0]), z])
    blocks = out[0].reshape(4, rows + 2 * halo, 8)
    for s in range(4):
        check(np.array_equal(blocks[s], padded[s * rows:
                                               s * rows + rows + 2 * halo]),
              f"halo rows of shard {s} came from the wrong neighbour")
    say("halo", f"ppermute halo of {halo} rows lands on the right "
                f"neighbour across {len(jax.devices())} cards")


def phase_sharded(cams, projs):
    import jax
    import jax.numpy as jnp

    from custereomatching_tpu import StereoConfig, StereoMatcher
    from custereomatching_tpu.config import MeshConfig
    from custereomatching_tpu.parallel import (
        make_mesh, shard_batch, sharded_cost_volume, sharded_disparity_maps)

    cfg = StereoConfig(kernel_size=K, num_disparities=D)
    single = jax.jit(StereoMatcher(cfg).disparity_maps)
    volume = jax.jit(StereoMatcher(cfg).cost_volume)

    mesh = make_mesh(MeshConfig(data=4, space=1))
    c, p = jnp.asarray(cams), jnp.asarray(projs)
    want = single(c, p)
    cs, ps = shard_batch((c, p), mesh)
    fn = jax.jit(lambda a, b: sharded_disparity_maps(a, b, cfg, mesh))
    compare_maps("sharded data=4", fn(cs, ps), want, np.asarray(volume(c, p)))
    say("sharded data=4", f"B=4 KITTI: {ms(timed(fn, cs, ps))}")

    # Rows padded to 376 = 4×94 with a zero row: exact for the 375 real
    # rows under the zero-padding window convention.
    mesh = make_mesh(MeshConfig(data=1, space=4))
    c1 = jnp.pad(c[:1], ((0, 0), (0, 1), (0, 0)))
    p1 = jnp.pad(p[:1], ((0, 0), (0, 1), (0, 0)))
    want = jax.tree_util.tree_map(lambda x: x[:, :H], single(c[:1], p[:1]))
    cs, ps = shard_batch((c1, p1), mesh)
    fn = jax.jit(lambda a, b: sharded_disparity_maps(a, b, cfg, mesh))
    got = jax.tree_util.tree_map(lambda x: x[:, :H], fn(cs, ps))
    compare_maps("sharded space=4", got, want, np.asarray(volume(c[:1], p[:1])))
    say("sharded space=4", f"B=1 KITTI: {ms(timed(fn, cs, ps))}")

    g = jax.random.normal(jax.random.PRNGKey(3), (1, H + 1, W, D + 1))
    loss_1 = jax.jit(jax.value_and_grad(
        lambda a, b, g: jnp.sum(StereoMatcher(cfg).cost_volume(a, b) * g)))
    loss_s = jax.jit(jax.value_and_grad(
        lambda a, b, g: jnp.sum(sharded_cost_volume(a, b, cfg, mesh) * g)))
    (_, g1), (_, gs) = loss_1(c1, p1, g), loss_s(cs, ps, g)
    cv1 = np.asarray(StereoMatcher(cfg).cost_volume(c1, p1))
    cvs = np.asarray(jax.jit(lambda a, b: sharded_cost_volume(
        a, b, cfg, mesh))(cs, ps))
    err = float(np.abs(cvs - cv1).max())
    scale = float(np.abs(np.asarray(g1)).max())
    gerr = float(np.abs(np.asarray(gs) - np.asarray(g1)).max()) / scale
    say("sharded volume space=4", f"volume max|d| {err:.3g}, camera grad "
                                  f"max|d|/max|g| {gerr:.3g} vs one card")
    check(err <= 1e-5, f"sharded volume off by {err}")
    check(gerr <= 1e-5, f"sharded gradient off by {gerr}")
    say("sharded volume space=4", f"forward+backward: "
                                  f"{ms(timed(loss_s, cs, ps, g, n=5))}")


def phase_pipeline(cams, projs):
    import jax
    import jax.numpy as jnp

    from custereomatching_tpu import StereoConfig, StereoMatcher
    from custereomatching_tpu.parallel import pipelined_video_maps, stage_mesh

    # 192 planes split into 4 stages of 48 (the split must be exact).
    cfg = StereoConfig(kernel_size=K, num_disparities=191)
    mesh = stage_mesh(4)
    c, p = jnp.asarray(cams), jnp.asarray(projs)
    fn = jax.jit(lambda a, b: pipelined_video_maps(a, b, cfg, mesh))
    got = fn(c, p)
    want = jax.jit(StereoMatcher(cfg).disparity_maps)(c, p)
    volume = np.asarray(jax.jit(StereoMatcher(cfg).cost_volume)(c, p))
    compare_maps("pipeline S=4", got, want, volume)
    say("pipeline S=4", f"4 KITTI frames through 4 stages: "
                        f"{ms(timed(fn, c, p, n=5))}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded and pipeline-parallel paths "
                         "on four cards, each against one card")
    args = ap.parse_args()

    import jax

    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev[0].platform!r}",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(dev) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(dev)}",
              file=sys.stderr)
        return 2

    from custereomatching_tpu.utils.cache import enable_compile_cache

    global CARD
    cards = card()
    print(cards, flush=True)
    lines = cards.splitlines()
    CARD = (lines[0] if len(set(lines)) == 1 else "; ".join(lines))
    if len(lines) > 1:
        CARD = f"{len(lines)}x {CARD}"
    say("device", f"{CARD}; platform {dev[0].platform}, kind "
                  f"{dev[0].device_kind!r}, count {len(dev)}; compile cache "
                  f"{enable_compile_cache()}")

    t_start = time.perf_counter()
    cams, projs, truth = kitti_batch(4)
    if args.four_cards:
        phase_halo()
        phase_sharded(cams, projs)
        phase_pipeline(cams, projs)
    else:
        phase_inference(cams, projs, truth)
        phase_kernel_vs_xla(cams, projs)
        phase_volume(cams, projs)
        phase_allpairs()
        phase_train(cams, projs)
        phase_pyramid_lr(cams, projs, truth)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
