"""Shared types, frames and errors."""
