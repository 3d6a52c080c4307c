"""Shared types, frames, errors, the default device and runtime metrics."""
