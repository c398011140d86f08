"""Utility runner: `python -m mitsuba_tpu.mtsutil <tool> ...`.

Analog of the reference's `mtsutil` plugin runner
(src/mitsuba/mtsutil.cpp) with the utilities from src/utils/:
  kdbench    — rays/second benchmark (kdbench.cpp:35-66)
  tonemap    — HDR -> LDR conversion (tonemap.cpp)
  addimages  — weighted sum of two images (addimages.cpp)
  joinrgb    — merge three single-channel images into RGB (joinrgb.cpp)
  mtsimport  — COLLADA .dae -> scene XML + .serialized (mtsimport.cpp)
"""
from __future__ import annotations

import argparse
import sys
import time


def tool_kdbench(argv):
    ap = argparse.ArgumentParser(prog="mtsutil kdbench")
    ap.add_argument("scene", nargs="?", default=None,
                    help="scene XML (default: built-in Cornell box)")
    ap.add_argument("-n", "--rays", type=int, default=1 << 20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    from .ops import trace
    from .scene import builtin, xml as xmllib

    if args.scene:
        scene, _, _, _ = xmllib.load_xml(args.scene)
        scene = trace.with_bvh_if_walked(scene)
    else:
        scene, _ = builtin.cornell_box()

    # uniform rays through the scene bounding sphere (kdbench.cpp protocol)
    lo = jnp.min(scene.vertices, 0)
    hi = jnp.max(scene.vertices, 0)
    center = (lo + hi) / 2
    radius = float(jnp.linalg.norm(hi - lo)) / 2
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    a = jax.random.normal(k1, (args.rays, 3))
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = jax.random.normal(k2, (args.rays, 3))
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    o = center + a * radius
    d = jnp.where(jnp.abs(jnp.sum(a * b, -1, keepdims=True)) > 0.999, -a,
                  (b - a * jnp.sum(a * b, -1, keepdims=True)))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    f = jax.jit(lambda s, o_, d_: trace.closest_hit(s, o_, d_).t)
    r = f(scene, o, d)
    r.block_until_ready()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        r = f(scene, o, d)
    r.block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    print(f"{scene.num_triangles} triangles, {args.rays} rays: "
          f"{args.rays / dt / 1e6:.2f} M rays/s ({dt * 1e3:.2f} ms/batch)")


def tool_tonemap(argv):
    ap = argparse.ArgumentParser(prog="mtsutil tonemap")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-m", "--multiplier", type=float, default=1.0)
    ap.add_argument("-g", "--gamma", type=float, default=-1.0,
                    help="-1 = sRGB curve (default)")
    args = ap.parse_args(argv)
    import numpy as np
    from .io import image

    img = image.read_auto(args.input) * args.multiplier
    out = args.output or (args.input.rsplit(".", 1)[0] + ".png")
    if args.gamma > 0:
        ldr = np.clip(img, 0, 1) ** (1.0 / args.gamma)
        image.write_png(out, ldr, tonemap=False)
    else:
        image.write_png(out, img, tonemap=True)
    print(f"wrote {out}")


def tool_addimages(argv):
    ap = argparse.ArgumentParser(prog="mtsutil addimages")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("output")
    ap.add_argument("--wa", type=float, default=1.0)
    ap.add_argument("--wb", type=float, default=1.0)
    args = ap.parse_args(argv)
    from .io import image

    img = image.read_auto(args.a) * args.wa + image.read_auto(args.b) * args.wb
    image.write_image(args.output, img)
    print(f"wrote {args.output}")


def tool_joinrgb(argv):
    ap = argparse.ArgumentParser(prog="mtsutil joinrgb")
    ap.add_argument("r")
    ap.add_argument("g")
    ap.add_argument("b")
    ap.add_argument("output")
    args = ap.parse_args(argv)
    import numpy as np
    from .io import image

    chans = [image.read_auto(p) for p in (args.r, args.g, args.b)]
    chans = [c[..., 0] if c.ndim == 3 else c for c in chans]
    image.write_image(args.output, np.stack(chans, -1))
    print(f"wrote {args.output}")


def tool_mtsimport(argv):
    """COLLADA -> scene conversion (src/converter/mtsimport.cpp analog):
    parse the .dae, write the meshes as one .serialized file and a scene
    XML referencing them with a default sensor + constant light."""
    ap = argparse.ArgumentParser(prog="mtsutil mtsimport")
    ap.add_argument("dae", help="input COLLADA .dae file")
    ap.add_argument("out", help="output scene .xml path")
    ap.add_argument("--fov", type=float, default=45.0)
    args = ap.parse_args(argv)
    from pathlib import Path

    from .io import collada, serialized as serlib

    meshes = collada.load_dae(args.dae)
    if not meshes:
        raise SystemExit(f"no triangle geometry found in {args.dae}")
    out = Path(args.out)
    ser = out.with_suffix(".serialized")
    serlib.write_serialized(ser, meshes)

    shapes = "\n".join(
        f'    <shape type="serialized">\n'
        f'        <string name="filename" value="{ser.name}"/>\n'
        f'        <integer name="shapeIndex" value="{i}"/>\n'
        f'        <bsdf type="diffuse"/>\n'
        f'    </shape>' for i in range(len(meshes)))
    out.write_text(f"""<scene version="0.6.0">
    <integrator type="path"/>
    <sensor type="perspective">
        <float name="fov" value="{args.fov}"/>
        <film type="hdrfilm">
            <integer name="width" value="256"/>
            <integer name="height" value="256"/>
        </film>
    </sensor>
    <emitter type="constant"><rgb name="radiance" value="1, 1, 1"/></emitter>
{shapes}
</scene>
""")
    total = sum(len(m.indices) for m in meshes)
    print(f"imported {len(meshes)} mesh(es), {total} triangles -> "
          f"{out} + {ser.name}")


def tool_rendertime(argv):
    """Print render-time metadata embedded in EXR headers
    (data/scripts/rendertime.py:14 analog)."""
    ap = argparse.ArgumentParser(prog="mtsutil rendertime")
    ap.add_argument("images", nargs="+", help="EXR file(s)")
    args = ap.parse_args(argv)
    from .io import image as imagelib

    total = 0.0
    for p in args.images:
        attrs = imagelib.read_exr_attrs(p)
        t = attrs.get("renderTime")
        if t is None:
            print(f"{p}: no renderTime attribute")
        else:
            print(f"{p}: {float(t):.2f} s"
                  + (f" ({attrs['spp']:.0f} spp)" if "spp" in attrs else ""))
            total += float(t)
    if len(args.images) > 1:
        print(f"total: {total:.2f} s")


TOOLS = {
    "kdbench": tool_kdbench,
    "rendertime": tool_rendertime,
    "tonemap": tool_tonemap,
    "addimages": tool_addimages,
    "joinrgb": tool_joinrgb,
    "mtsimport": tool_mtsimport,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in TOOLS:
        print(f"usage: python -m mitsuba_tpu.mtsutil <tool> ...\n"
              f"tools: {', '.join(sorted(TOOLS))}", file=sys.stderr)
        return 1
    TOOLS[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
