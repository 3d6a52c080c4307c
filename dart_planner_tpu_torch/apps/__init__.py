"""Application entry points (PyTorch counterpart of
:mod:`dart_planner_tpu.apps`).

Mirrors the reference's app tier: the three-layer cloud planning service
(cloud/main_improved_threelayer.py), the edge control loop
(edge/main_improved.py), the onboard autonomous controller with its tiered
failsafe (edge/onboard_autonomous_controller.py) and a minimal takeoff demo
(minimal_takeoff.py). The ``dart-planner-tpu`` CLI and the websocket web
demo are not ported yet.
"""
