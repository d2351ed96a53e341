"""The harness's own machinery: environment, manifest, seeded inputs,
tracing and the result line.  Nothing here imports the program at
import time."""
