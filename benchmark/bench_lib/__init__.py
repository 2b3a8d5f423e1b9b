"""The benchmark's own library: cells by name, seeded inputs and weights,
tracing, the yardstick's arithmetic (FLOPs, kernel bounds, peaks) and the
comparison that decides ``correct``. It imports nothing of JAX, and the
program under test only where a driver hands it its inputs."""
