"""Renders and meshes from a trained map: the port of ``examples/render_map.py``.

Loads a run directory's last checkpoint (``load_run``) and renders along a
TUM trajectory, or at one pose:

    python -m loner_tpu_torch.render_map lidar --run <run dir> --poses <traj.txt> --out cloud.pcd
    python -m loner_tpu_torch.render_map mesh  --run <run dir> --poses <traj.txt> --out mesh.ply
    python -m loner_tpu_torch.render_map depth --run <run dir> --poses <traj.txt> --out depth_dir/
    python -m loner_tpu_torch.render_map video --run <run dir> --poses <traj.txt> --out flythrough.gif

``lidar`` writes the voxel-downsampled cloud of virtual scans (``.pcd``, or
``.npy``), ``mesh`` an ASCII PLY, ``depth`` colormapped depth PNGs (with
``--rgb`` intensity and with ``--peak-consistency`` peak-depth PNGs too),
``video`` a fly-through along an interpolated camera path with periodic
360-degree spins. The PNG and video modes need matplotlib and imageio. It
runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m loner_tpu_torch.render_map")
    ap.add_argument("mode", choices=["lidar", "mesh", "depth", "video"])
    ap.add_argument("--run", required=True, help="run directory with full_config.pkl and checkpoints/")
    ap.add_argument("--poses", default=None, help="TUM trajectory to render along")
    ap.add_argument("--out", required=True)
    ap.add_argument("--skip-step", type=int, default=4)
    ap.add_argument("--resolution", type=int, default=128, help="mesh grid resolution")
    ap.add_argument("--level", type=float, default=0.1, help="mesh iso level")
    ap.add_argument("--var-threshold", type=float, default=1e-2)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--render-strategy", default="default", choices=["default", "adjusted"],
                    help="adjusted = FDT rise-delta peak depth (foliage multi-return)")
    ap.add_argument("--rgb", action="store_true", help="also write intensity images")
    ap.add_argument("--peak-consistency", action="store_true",
                    help="also write |argmax-weight depth - expected depth| maps")
    ap.add_argument("--only-last-frame", action="store_true", help="render only the trajectory's final pose")
    ap.add_argument("--render-pose", default=None,
                    help="render one pose 'x,y,z,yaw,pitch,roll' (metres, degrees) instead of the trajectory")
    ap.add_argument("--velocity", type=float, default=1.0, help="fly-through m/s (video)")
    ap.add_argument("--fps", type=float, default=5.0)
    ap.add_argument("--spin-spacing-m", type=float, default=10.0, help="a 360 spin every this many metres (0: never)")
    ap.add_argument("--spin-duration-s", type=float, default=15.0)
    ap.add_argument("--no-interp", action="store_true", help="render the raw trajectory poses")
    ap.add_argument("--max-depth", type=float, default=50.0, help="depth colormap range")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap


def _poses(ap, args):
    from loner_tpu_torch.runtime.trajectory_logger import load_tum

    if args.render_pose is not None:
        from scipy.spatial.transform import Rotation

        vals = [float(v) for v in args.render_pose.split(",")]
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("ZYX", vals[3:], degrees=True).as_matrix()
        T[:3, 3] = vals[:3]
        return np.asarray([T])
    if args.poses is None:
        ap.error("--poses is required unless --render-pose is given")
    poses, _ = load_tum(args.poses)
    return poses[-1:] if args.only_last_frame else poses


def _intrinsics(args) -> np.ndarray:
    return np.array([[args.width / 2, 0, args.width / 2], [0, args.width / 2, args.height / 2], [0, 0, 1.0]])


def main(argv: Optional[List[str]] = None) -> dict:
    """Render or mesh as ``mode`` says; returns what was written: the
    cloud's points, the mesh's vertex and face counts with the mesher's
    seconds by part, or the images' and frames' count."""
    ap = _parser()
    args = ap.parse_args(argv)
    from loner_tpu_torch.analysis.mesher import Mesher, save_pcd, save_ply
    from loner_tpu_torch.analysis.renderer import assemble_global_cloud, render_camera_image
    from loner_tpu_torch.device import resolve_device
    from loner_tpu_torch.runtime.run_io import load_run

    cfg, cube, state = load_run(args.run, device=resolve_device(args.device))
    poses = _poses(ap, args)

    if args.mode == "lidar":
        cloud = assemble_global_cloud(cfg, cube, state, poses, skip_step=args.skip_step,
                                      var_threshold=args.var_threshold)
        if args.out.endswith(".npy"):
            np.save(args.out, cloud)
        else:
            save_pcd(args.out, cloud)
        print(f"[render_map] {len(cloud)} points -> {args.out}")
        return {"points": len(cloud)}
    if args.mode == "mesh":
        mesher = Mesher(cfg, cube, state)
        verts, faces = mesher.get_mesh(poses, resolution=args.resolution, level=args.level, skip_step=args.skip_step)
        save_ply(args.out, verts, faces)
        print(f"[render_map] mesh {len(verts)} verts / {len(faces)} faces -> {args.out}")
        return {"vertices": len(verts), "faces": len(faces), "timings": mesher.last_timings}
    K = _intrinsics(args)
    if args.mode == "depth":
        from loner_tpu_torch.analysis.render_utils import save_depth_png, save_rgb_png

        os.makedirs(args.out, exist_ok=True)
        selected = poses[::args.skip_step]
        for i, pose in enumerate(selected):
            img = render_camera_image(cfg, cube, state, pose, K, args.height, args.width, rgb=args.rgb,
                                      render_strategy=args.render_strategy, peak_consistency=args.peak_consistency)
            save_depth_png(img["depth"], os.path.join(args.out, f"depth_{i:04d}.png"), max_depth=args.max_depth)
            if args.rgb:
                save_rgb_png(img["rgb"], os.path.join(args.out, f"rgb_{i:04d}.png"))
            if args.peak_consistency:
                save_depth_png(img["peak_depth"], os.path.join(args.out, f"peak_depth_{i:04d}.png"),
                               min_depth=0.0, max_depth=5.0)
        print(f"[render_map] depth images -> {args.out}")
        return {"images": len(selected)}

    # video: an interpolated fly-through with periodic 360 spins
    from loner_tpu_torch.analysis.render_utils import depth_colormap, interpolate_camera_path, write_video

    path_poses, spin_idxs = interpolate_camera_path(poses, velocity=args.velocity, fps=args.fps,
                                                    spin_spacing_m=args.spin_spacing_m or None,
                                                    spin_duration_s=args.spin_duration_s, no_interp=args.no_interp)
    frames = []
    for i, pose in enumerate(path_poses):
        img = render_camera_image(cfg, cube, state, pose, K, args.height, args.width, rgb=args.rgb,
                                  render_strategy=args.render_strategy)
        depth_rgb = depth_colormap(img["depth"], max_depth=args.max_depth)[..., :3]
        if args.rgb:
            g = (np.clip(img["rgb"], 0, 1) * 255).astype(np.uint8)
            if g.shape[-1] == 1:
                g = np.repeat(g, 3, axis=-1)
            frames.append(np.concatenate([depth_rgb, g], axis=1))
        else:
            frames.append(depth_rgb)
        if (i + 1) % 20 == 0:
            print(f"[render_map] frame {i + 1}/{len(path_poses)}")
    write_video(frames, args.out, fps=args.fps)
    print(f"[render_map] {len(frames)} frames ({len(spin_idxs)} spins) -> {args.out}")
    return {"frames": len(frames), "spins": len(spin_idxs)}


if __name__ == "__main__":
    main()
