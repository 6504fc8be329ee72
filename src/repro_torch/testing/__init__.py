"""Test harness of the port: deterministic fault injection and a runner
that spawns a small process group on the CPU."""
