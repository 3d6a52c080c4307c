"""Shared types, frames, errors, the default device, runtime metrics, the
DI container, SI units, state buffers and error recovery."""
