"""Rollout and serving engines of the port."""
