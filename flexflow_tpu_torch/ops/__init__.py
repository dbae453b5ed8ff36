"""Operators of the port: the generation path's attention."""
