"""Serving layer of the port: the fleet planner and its result cache."""
