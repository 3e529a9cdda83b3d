"""Launchers of the port: the serving steps and the serving CLI."""
