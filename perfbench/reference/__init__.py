"""Plain PyTorch references: they import nothing of the port and take
nothing the port made; the harness hands both sides the same inputs."""
