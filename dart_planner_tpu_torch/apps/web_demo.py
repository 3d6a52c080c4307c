"""Browser demo: interactive SE(3) MPC flight with live metrics + 3-D view
(PyTorch counterpart of :mod:`dart_planner_tpu.apps.web_demo`).

Parity rebuild of the reference web demo (its demos/web_demo/app.py,
"WD"): scenario catalogue + selection (WD:142-190), REST control surface
(``/api/scenarios`` ``/api/status`` ``/api/start/<name>`` ``/api/stop``
``/api/health``, WD:411-476), WebSocket state broadcast with the same
message shapes (``state_update`` / ``mission_completed``, WD:383-407),
and a 3-D trajectory view. The server is stdlib ``http.server`` (REST +
static page) + the ``websockets`` package (state stream); the 3-D view is
a dependency-free canvas renderer (no CDN three.js).

Like the JAX package's demo, it flies the REAL stack — SE(3) MPC replans
at 10 Hz against obstacles perceived through the voxel mapper, the
geometric controller + rigid-body physics underneath
(hardware/simulated_vehicle.py) — and every metric shown is measured.
The engine's vehicle, planner and mapper live on one device (default: the
card, where each plan is kernel B1). Every host read of a tensor goes
through :func:`~dart_planner_tpu_torch.common.device.to_host`, and
``planning_time_ms`` covers a plan until its positions are on the host.
"""

from __future__ import annotations

import asyncio
import http.server
import json
import threading
import time
from typing import Any, Dict, List, Optional, Set

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device, to_host
from dart_planner_tpu_torch.common.logging_config import get_logger
from dart_planner_tpu_torch.common.metrics import get_metrics
from dart_planner_tpu_torch.hardware.simulated_vehicle import SimulatedVehicleIO
from dart_planner_tpu_torch.perception import GeometricMapper
from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner

logger = get_logger("apps.web_demo")

# Scenario catalogue (reference WD:142-190; constants are the spec).
DEMO_SCENARIOS: Dict[str, Dict[str, Any]] = {
    "obstacle_avoidance": {
        "name": "Obstacle Avoidance Challenge",
        "description": "Navigate a complex obstacle field using SE(3) MPC",
        "start_pos": [0.0, 0.0, 10.0],
        "goal_pos": [50.0, 0.0, 10.0],
        "obstacles": [
            {"pos": [10.0, 0.0, 10.0], "radius": 3.0},
            {"pos": [20.0, 5.0, 8.0], "radius": 2.0},
            {"pos": [30.0, -3.0, 12.0], "radius": 2.5},
            {"pos": [40.0, 2.0, 9.0], "radius": 3.0},
        ],
    },
    "precision_landing": {
        "name": "Precision Landing",
        "description": "Precise descent to a pad with geometric control",
        "start_pos": [0.0, 0.0, 20.0],
        # reference lands at z=0; our planner's ground-clearance hinge
        # (min_altitude=0.3 m) holds the hover just above the pad
        "goal_pos": [0.0, 0.0, 0.5],
        "obstacles": [],
    },
    "edge_autonomy": {
        "name": "Edge-First Autonomy",
        "description": "Full autonomy without cloud connectivity",
        "start_pos": [0.0, 0.0, 15.0],
        "goal_pos": [30.0, 20.0, 15.0],
        "obstacles": [
            {"pos": [15.0, 10.0, 15.0], "radius": 4.0},
            {"pos": [25.0, 15.0, 12.0], "radius": 3.0},
        ],
    },
    "multi_waypoint": {
        "name": "Multi-Waypoint Mission",
        "description": "Waypoint chain with dynamic replanning",
        "start_pos": [0.0, 0.0, 12.0],
        "goal_pos": [60.0, 40.0, 12.0],
        "waypoints": [
            [15.0, 10.0, 12.0],
            [30.0, 20.0, 15.0],
            [45.0, 30.0, 10.0],
            [60.0, 40.0, 12.0],
        ],
        "obstacles": [
            {"pos": [10.0, 5.0, 12.0], "radius": 2.0},
            {"pos": [25.0, 15.0, 12.0], "radius": 3.0},
            {"pos": [40.0, 25.0, 12.0], "radius": 2.5},
        ],
    },
}

WAYPOINT_RADIUS = 1.5  # m; advance threshold (WD:361 uses 0.5 on a lerp)


class DemoEngine:
    """Scenario lifecycle + the real plan->fly loop (WD:192-407). Each
    scenario's vehicle, planner and mapper are made on ``device``
    (default: the card)."""

    def __init__(self, replan_hz: float = 10.0, control_hz: float = 400.0, device=None):
        self.device = resolve_device(device)
        self.replan_hz = replan_hz
        self.substeps = max(1, int(control_hz / replan_hz))
        self.is_running = False
        self.current_scenario: Optional[str] = None
        self.trajectory: List[List[float]] = []
        self.metrics: Dict[str, float] = {}
        self.start_time: Optional[float] = None
        self._flight_task: Optional[asyncio.Task] = None
        self.clients: Set = set()
        self.vehicle: Optional[SimulatedVehicleIO] = None
        self.planner: Optional[SE3MPCPlanner] = None
        self.mapper: Optional[GeometricMapper] = None
        self.obstacles: List[List[float]] = []
        self.goal = np.zeros(3, np.float32)
        self.waypoints: List[np.ndarray] = []
        self.waypoint_idx = 0
        self.reset_metrics()

    # -- lifecycle (WD:192-216) --
    def reset_metrics(self) -> None:
        self.metrics = {
            "planning_time_ms": 0.0,
            "mapping_queries_per_sec": 0.0,
            "autonomous_time_sec": 0.0,
            "success_rate": 0.0,
            "tracking_error_m": 0.0,
        }

    def status(self) -> Dict[str, Any]:
        """(WD:425-434)"""
        pos = (
            to_host(self.vehicle.get_state().position).tolist()
            if self.vehicle is not None
            else [0.0, 0.0, 0.0]
        )
        return {
            "is_running": self.is_running,
            "current_scenario": self.current_scenario,
            "position": pos,
            "performance": self.metrics,
            "connected_clients": len(self.clients),
        }

    def start(self, scenario_name: str) -> bool:
        """(WD:436-451) — returns False for unknown scenarios."""
        sc = DEMO_SCENARIOS.get(scenario_name)
        if sc is None or self.is_running:
            return False
        self.current_scenario = scenario_name
        self.trajectory = []
        self.reset_metrics()
        self.waypoint_idx = 0
        self.goal = np.asarray(sc["goal_pos"], np.float32)
        self.waypoints = [
            np.asarray(w, np.float32) for w in sc.get("waypoints", [])
        ] or [self.goal]
        self.obstacles = [
            [*map(float, o["pos"]), float(o["radius"])]
            for o in sc["obstacles"]
        ]
        self.vehicle = SimulatedVehicleIO(
            {"initial_position": tuple(sc["start_pos"])}, device=self.device
        )
        self.vehicle.armed = True
        self.planner = SE3MPCPlanner(SE3MPCConfig(), device=self.device)
        # obstacle fields reach the planner THROUGH the mapper, as in the
        # reference cloud loop (cloud/main_improved_threelayer.py:381-398)
        self.mapper = GeometricMapper(device=self.device)
        for o in self.obstacles:
            self.mapper.add_obstacle(np.asarray(o[:3], np.float32), o[3])
        corridor = (np.asarray(sc["start_pos"]) + self.goal) / 2
        obs, mask = self.mapper.extract_obstacles(
            corridor.astype(np.float32), max_obstacles=8
        )
        for o, valid in zip(obs, mask):
            if valid:
                self.planner.add_obstacle(
                    np.asarray(o[:3], np.float32), float(o[3])
                )
        self.start_time = time.time()
        self.is_running = True
        self._flight_task = asyncio.ensure_future(self._fly())
        logger.info("demo scenario started: %s", sc["name"])
        return True

    async def stop(self) -> None:
        """(WD:453-465)"""
        self.is_running = False
        if self._flight_task is not None:
            self._flight_task.cancel()
            try:
                await self._flight_task
            except asyncio.CancelledError:
                pass
            self._flight_task = None

    # -- flight loop (WD:318-407, made real) --
    async def _fly(self) -> None:
        assert self.vehicle and self.planner and self.mapper
        max_ticks = int(90 * self.replan_hz)  # 90 s mission budget
        success = False
        for tick in range(max_ticks):
            if not self.is_running:
                break
            state = self.vehicle.get_state()
            pos = to_host(state.position)

            # waypoint advance (WD:349-366)
            target = self.waypoints[self.waypoint_idx]
            if np.linalg.norm(pos - target) < WAYPOINT_RADIUS:
                if self.waypoint_idx + 1 < len(self.waypoints):
                    self.waypoint_idx += 1
                    target = self.waypoints[self.waypoint_idx]
                else:
                    success = True
                    break

            # the plan's time runs until its positions are on the host
            t0 = time.perf_counter()
            traj = self.planner.plan_trajectory(state, target)
            plan_np = to_host(traj.positions, np.float32)
            plan_ms = (time.perf_counter() - t0) * 1e3
            await self.vehicle.send_trajectory(traj)
            for _ in range(self.substeps):
                self.vehicle.step()

            # measured mapping-query throughput over the plan's positions
            t0 = time.perf_counter()
            self.mapper.is_trajectory_safe(plan_np)
            q_s = plan_np.shape[0] / max(time.perf_counter() - t0, 1e-9)

            new = self.vehicle.get_state()
            new_pos, new_vel = to_host(
                torch.stack([new.position, new.velocity]), np.float32
            )
            track_err = float(
                np.min(np.linalg.norm(plan_np - new_pos[None, :], axis=1))
            )
            self.trajectory.append(new_pos.tolist())
            # feed the ops stack (deploy/: Prometheus scrapes these via
            # MetricsManager.serve when a metrics port is configured)
            mx = get_metrics()
            mx.record("planning_time_ms", plan_ms)
            mx.record("tracking_error_m", track_err)
            mx.increment("replans")
            stats = self.planner.get_planning_stats()
            self.metrics.update(
                planning_time_ms=round(plan_ms, 2),
                mapping_queries_per_sec=round(q_s, 1),
                autonomous_time_sec=round(time.time() - self.start_time, 2),
                success_rate=round(100.0 * stats.get("success_rate", 0.0), 1),
                tracking_error_m=round(track_err, 3),
            )
            await self._broadcast(
                {
                    "type": "state_update",
                    "drone_state": {
                        "position": new_pos.tolist(),
                        "velocity": new_vel.tolist(),
                    },
                    "plan": plan_np.tolist(),
                    "trajectory": self.trajectory[-400:],
                    "performance": self.metrics,
                    "scenario": self.current_scenario,
                    "obstacles": self.obstacles,
                    "goal": self.goal.tolist(),
                    "target": target.tolist(),
                    "status": "running",
                }
            )
            await asyncio.sleep(1.0 / self.replan_hz)

        self.is_running = False
        await self._broadcast(
            {
                "type": "mission_completed",
                "scenario": self.current_scenario,
                "performance": self.metrics,
                "trajectory": self.trajectory,
                "success": success,
            }
        )
        logger.info(
            "demo scenario finished: %s success=%s",
            self.current_scenario,
            success,
        )

    async def _broadcast(self, message: Dict[str, Any]) -> None:
        """(WD:300-316)"""
        if not self.clients:
            return
        payload = json.dumps(message)
        await asyncio.gather(
            *(c.send(payload) for c in list(self.clients)),
            return_exceptions=True,
        )


PAGE = """<!DOCTYPE html>
<html><head><title>DART-Planner demo (PyTorch)</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:16px}
canvas{background:#151526;border:1px solid #444;cursor:grab}
button{background:#233;color:#ddd;border:1px solid #566;margin:2px;
padding:6px 10px;font-family:monospace;cursor:pointer}
button.active{background:#375}
#metrics{margin-top:8px;white-space:pre;color:#9fd}
#banner{color:#fc3}
</style></head><body>
<h3>DART-Planner (PyTorch) &mdash; live SE(3) MPC (drag to orbit)</h3>
<div id="buttons"></div>
<canvas id="c" width="760" height="560"></canvas>
<div id="banner"></div>
<div id="metrics">select a scenario&hellip;</div>
<script>
const c=document.getElementById('c'),x=c.getContext('2d');
const W=c.width,H=c.height;
let yaw=-0.7,pitch=0.45,zoom=9,center=[25,10,10],frame=null;
let drag=null;
c.onmousedown=e=>{drag=[e.clientX,e.clientY];c.style.cursor='grabbing'};
window.onmouseup=()=>{drag=null;c.style.cursor='grab'};
window.onmousemove=e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*.008;pitch+=(e.clientY-drag[1])*.008;
  pitch=Math.max(.05,Math.min(1.5,pitch));drag=[e.clientX,e.clientY];draw();};
c.onwheel=e=>{e.preventDefault();zoom*=e.deltaY>0?1.1:.9;draw();};
function proj(p){ // orbit camera, perspective projection
  const dx=p[0]-center[0],dy=p[1]-center[1],dz=p[2]-center[2];
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const rx=cy*dx+sy*dy, ry=-sy*dx+cy*dy;
  const vz=cp*ry+sp*dz, vy=-sp*ry+cp*dz, vx=rx;
  const d=zoom*8-vz, s=900/Math.max(d,1);
  return [W/2+vx*s, H*0.55-vy*s, s];
}
function poly(pts,style,w){x.beginPath();x.strokeStyle=style;x.lineWidth=w||1.5;
  pts.forEach((p,i)=>{const q=proj(p);i?x.lineTo(q[0],q[1]):x.moveTo(q[0],q[1])});
  x.stroke();x.lineWidth=1;}
function draw(){
  x.clearRect(0,0,W,H);
  // ground grid
  x.strokeStyle='#262640';
  for(let i=-10;i<=70;i+=10){poly([[i,-20,0],[i,50,0]],'#262640');
    poly([[-10,i-10,0],[70,i-10,0]],'#262640');}
  if(!frame)return;
  (frame.obstacles||[]).forEach(o=>{const q=proj(o);x.beginPath();
    x.arc(q[0],q[1],o[3]*q[2],0,7);x.fillStyle='rgba(205,70,70,.45)';x.fill();
    x.strokeStyle='#c55';x.stroke();});
  if(frame.trajectory)poly(frame.trajectory,'#57c',2);
  if(frame.plan)poly(frame.plan,'#4c9',1.5);
  if(frame.goal){const g=proj(frame.goal);x.fillStyle='#fc3';
    x.fillRect(g[0]-4,g[1]-4,8,8);}
  if(frame.target){const t=proj(frame.target);x.strokeStyle='#fc3';
    x.beginPath();x.arc(t[0],t[1],6,0,7);x.stroke();}
  const p=frame.drone_state.position,q=proj(p);
  x.beginPath();x.arc(q[0],q[1],Math.max(4,.5*q[2]),0,7);
  x.fillStyle='#6af';x.fill();
  const sh=proj([p[0],p[1],0]);x.beginPath();x.strokeStyle='#446';
  x.moveTo(q[0],q[1]);x.lineTo(sh[0],sh[1]);x.stroke();
}
const ws=new WebSocket('ws://'+location.hostname+':'+(parseInt(location.port)+1));
ws.onmessage=e=>{
  const d=JSON.parse(e.data);
  if(d.type==='mission_completed'){
    document.getElementById('banner').textContent=
      'mission '+(d.success?'COMPLETE':'ended')+' — '+d.scenario;
    return;
  }
  frame=d;document.getElementById('banner').textContent='';
  const m=d.performance;
  document.getElementById('metrics').textContent=
    `scenario ${d.scenario}\\n`+
    `pos   ${d.drone_state.position.map(v=>v.toFixed(2)).join(', ')}\\n`+
    `plan  ${m.planning_time_ms} ms   track err ${m.tracking_error_m} m\\n`+
    `map   ${m.mapping_queries_per_sec} q/s   success ${m.success_rate}%\\n`+
    `autonomous ${m.autonomous_time_sec}s`;
  draw();
};
fetch('/api/scenarios').then(r=>r.json()).then(sc=>{
  const div=document.getElementById('buttons');
  Object.entries(sc).forEach(([key,s])=>{
    const b=document.createElement('button');
    b.textContent=s.name;b.title=s.description;
    b.onclick=()=>{fetch('/api/start/'+key,{method:'POST'})
      .then(()=>{document.querySelectorAll('button').forEach(
        e=>e.classList.remove('active'));b.classList.add('active');});};
    div.appendChild(b);});
  const stop=document.createElement('button');
  stop.textContent='stop';
  stop.onclick=()=>fetch('/api/stop',{method:'POST'});
  div.appendChild(stop);});
draw();
</script></body></html>"""


def _make_handler(engine: DemoEngine, loop: asyncio.AbstractEventLoop):
    """REST surface (WD:411-476) on stdlib http.server. Handlers run on
    server threads; engine mutations hop to the asyncio loop."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def _json(self, obj: Any, code: int = 200) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/" or self.path.startswith("/index"):
                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/scenarios":  # (WD:420-423)
                self._json(DEMO_SCENARIOS)
            elif self.path == "/api/status":  # (WD:425-434)
                self._json(engine.status())
            elif self.path == "/api/health":  # (WD:467-476)
                self._json(
                    {
                        "status": "healthy",
                        "timestamp": time.time(),
                        "demo_running": engine.is_running,
                    }
                )
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path.startswith("/api/start/"):  # (WD:436-451)
                name = self.path.rsplit("/", 1)[-1]
                if name not in DEMO_SCENARIOS:
                    self._json({"error": f"unknown scenario {name}"}, 404)
                    return
                if engine.is_running:
                    self._json({"error": "demo already running"}, 409)
                    return
                fut = asyncio.run_coroutine_threadsafe(
                    _start_on_loop(engine, name), loop
                )
                ok = fut.result(timeout=30)
                self._json(
                    {
                        "message": f"started {name}" if ok else "failed",
                        "scenario": DEMO_SCENARIOS[name],
                    },
                    200 if ok else 500,
                )
            elif self.path == "/api/stop":  # (WD:453-465)
                asyncio.run_coroutine_threadsafe(
                    engine.stop(), loop
                ).result(timeout=30)
                self._json({"message": "stopped"})
            else:
                self._json({"error": "not found"}, 404)

        def log_message(self, *a):  # quiet
            pass

    return Handler


async def _start_on_loop(engine: DemoEngine, name: str) -> bool:
    return engine.start(name)


async def main(
    port: int = 8080,
    duration: Optional[float] = None,
    autostart: Optional[str] = None,
    metrics_port: Optional[int] = None,
    device=None,
) -> None:
    """Serve the demo: page+REST on ``port``, WebSocket on ``port+1``; the
    engine flies on ``device`` (default: the card).

    ``metrics_port`` (or env ``DART_METRICS_PORT``) additionally serves
    the Prometheus exposition on ``/metrics`` for the deploy/ stack."""
    try:
        import websockets
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("websockets package required for the demo") from e

    import os

    if metrics_port is None and os.environ.get("DART_METRICS_PORT"):
        metrics_port = int(os.environ["DART_METRICS_PORT"])
    metrics_server = None
    if metrics_port:
        metrics_server = get_metrics().serve(
            metrics_port, host=os.environ.get("DART_METRICS_HOST", "127.0.0.1")
        )
        logger.info("metrics: http://127.0.0.1:%d/metrics", metrics_port)

    engine = DemoEngine(device=device)
    loop = asyncio.get_running_loop()
    httpd = http.server.ThreadingHTTPServer(
        ("127.0.0.1", port), _make_handler(engine, loop)
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    logger.info("web demo: http://127.0.0.1:%d (ws on %d)", port, port + 1)

    async def ws_handler(ws):
        engine.clients.add(ws)
        try:
            await ws.wait_closed()
        finally:
            engine.clients.discard(ws)

    try:
        async with websockets.serve(ws_handler, "127.0.0.1", port + 1):
            if autostart:
                engine.start(autostart)
            if duration:
                await asyncio.sleep(duration)
            else:
                await asyncio.Event().wait()  # serve forever
        await engine.stop()
    finally:
        httpd.shutdown()
        if metrics_server is not None:
            metrics_server.shutdown()
