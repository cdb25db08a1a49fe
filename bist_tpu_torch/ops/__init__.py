"""Kernels: the CUDA sources' build, their dispatch rules, their wrappers and plain versions."""
