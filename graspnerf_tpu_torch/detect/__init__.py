"""Grasp post-processing and the planner API."""
