"""Launchers of the port: the train, serve and federated CLIs, the step
builders, the meshes and the two dry runs."""
