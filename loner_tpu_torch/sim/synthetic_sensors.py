"""Map-as-simulator: lidar scans and camera frames rendered from a trained
map at any pose.

The port of ``loner_tpu/sim/synthetic_sensors.py``: an in-process service
over the renderers (``analysis/renderer.py``), and a JSON-lines TCP server
and client around it (one request a line: ``{"type": "lidar" | "camera" |
"ping", ...}``), which take the place of the reference's ROS nodes. The
renders run on the state's device.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from loner_tpu_torch.analysis.renderer import render_camera_image, render_lidar_scan


class SyntheticSensorService:
    """Sensors rendered at arbitrary poses from one map."""

    def __init__(self, cfg, cube, state):
        self.cfg = cfg
        self.cube = cube
        self.state = state

    @staticmethod
    def from_run_dir(run_dir: str, device="cuda") -> "SyntheticSensorService":
        """The service over a run directory's last checkpoint, on ``device``."""
        from loner_tpu_torch.runtime.run_io import load_run

        return SyntheticSensorService(*load_run(run_dir, device=device))

    def lidar_scan(self, pose: np.ndarray, n_channels: int = 32, n_azimuth: int = 512,
                   vfov_deg: Tuple[float, float] = (-22.5, 22.5),
                   var_threshold: Optional[float] = 1e-2) -> Dict[str, np.ndarray]:
        """A virtual sweep at ``pose``: :func:`render_lidar_scan`'s dict."""
        return render_lidar_scan(self.cfg, self.cube, self.state, np.asarray(pose), n_channels=n_channels,
                                 n_azimuth=n_azimuth, vfov_deg=vfov_deg, var_threshold=var_threshold)

    def camera_image(self, pose: np.ndarray, K: np.ndarray, height: int, width: int) -> Dict[str, np.ndarray]:
        return render_camera_image(self.cfg, self.cube, self.state, np.asarray(pose), np.asarray(K), height, width)


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            try:
                req = json.loads(line)
                svc: SyntheticSensorService = self.server.service
                if req["type"] == "lidar":
                    out = svc.lidar_scan(np.asarray(req["pose"]), n_channels=req.get("n_channels", 32),
                                         n_azimuth=req.get("n_azimuth", 512))
                    keep = out["keep"]
                    resp = {
                        "points": out["points"].tolist(),
                        "depth_summary": {
                            "mean": float(np.mean(out["depth"][keep])) if keep.any() else None,
                            "n_points": int(keep.sum()),
                        },
                    }
                elif req["type"] == "camera":
                    out = svc.camera_image(np.asarray(req["pose"]), np.asarray(req["K"]), req["height"], req["width"])
                    resp = {"depth": out["depth"].tolist(), "opacity": out["opacity"].tolist()}
                elif req["type"] == "ping":
                    resp = {"ok": True}
                else:
                    resp = {"error": f"unknown request type {req['type']}"}
            except Exception as e:  # noqa: BLE001 - the client gets the error
                resp = {"error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class SensorServer:
    """A JSON-lines TCP server around a :class:`SyntheticSensorService`."""

    def __init__(self, service: SyntheticSensorService, host: str = "127.0.0.1", port: int = 0):
        self._srv = socketserver.ThreadingTCPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv.service = service
        self.address = self._srv.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class SensorClient:
    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._rfile = self._sock.makefile("r")

    def request(self, payload: dict) -> dict:
        self._sock.sendall((json.dumps(payload) + "\n").encode())
        return json.loads(self._rfile.readline())

    def lidar(self, pose, **kw) -> dict:
        return self.request({"type": "lidar", "pose": np.asarray(pose).tolist(), **kw})

    def camera(self, pose, K, height, width) -> dict:
        return self.request({"type": "camera", "pose": np.asarray(pose).tolist(), "K": np.asarray(K).tolist(),
                             "height": height, "width": width})

    def close(self):
        self._rfile.close()
        self._sock.close()
