"""The seeded generator of the inputs."""
