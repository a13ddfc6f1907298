"""Bundled data of the port: the procedural atlas template."""
from .atlas import default_atlas

__all__ = ["default_atlas"]
