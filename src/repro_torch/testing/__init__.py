"""Test harness of the port: deterministic fault injection and a runner
that spawns a small process group on the CPU."""
from .faults import (FaultPlan, apply_wire_fault, crash_worker,
                     killed_checkpoint_writer, maybe_stall, poison_matvec,
                     preempt_after, serve_fault)

__all__ = ["FaultPlan", "apply_wire_fault", "crash_worker",
           "killed_checkpoint_writer", "maybe_stall", "poison_matvec",
           "preempt_after", "serve_fault"]
