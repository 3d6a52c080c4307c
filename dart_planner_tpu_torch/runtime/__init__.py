"""Planner-to-actuator fast path and the C++ real-time executor bindings."""
