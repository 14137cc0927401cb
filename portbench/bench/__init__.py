"""The benchmark's own harness code: spec resolution, device facts, seeded
inputs, trace reduction and the result line.  Nothing here imports the
program under test at import time."""
