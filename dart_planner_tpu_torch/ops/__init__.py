"""Numerical operators: dynamics, costs, SO(3), and the CUDA solver kernel."""
