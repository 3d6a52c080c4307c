"""Application entry points (PyTorch counterpart of
:mod:`dart_planner_tpu.apps`).

Mirrors the reference's app tier: the ``dart-planner-tpu-torch`` CLI
(dart_planner_cli.py; ``apps/cli.py``), the three-layer cloud planning
service (cloud/main_improved_threelayer.py), the edge control loop
(edge/main_improved.py), the onboard autonomous controller with its tiered
failsafe (edge/onboard_autonomous_controller.py), a minimal takeoff demo
(minimal_takeoff.py) and the websocket web demo (demos/web_demo). Each app
runs on one device, by default the card.
"""
