"""The restartable training loop (the port of ``repro.runtime``)."""
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              RestartableLoop, StepResult, StragglerWatchdog)
