"""Unified error taxonomy for the OCCL reproduction.

Every failure the runtime or the fault-tolerance layer can surface lives
here so callers catch one module's names regardless of which layer threw:

- :class:`RegistrationClosed` — topology mutation after the first build.
- :class:`DeadlockTimeout` — the daemon relaunched repeatedly with zero
  progress; carries the flight-recorder export and host diagnosis so the
  failure names its holder (see ``core/recorder.py``).
- :class:`EvictionError` — ``runtime.evict(rank)`` could not rebuild a
  registration for the shrunk communicator (e.g. ragged all-to-all
  ``chunk_sizes`` no longer match the group size).
- :class:`ConnDepthWarning` — connector rings too shallow for the
  registered burst width (progress still guaranteed, just slower).
- :class:`StepTimeout` — the fabric-level training watchdog fired.

The same taxonomy as the reference package's ``core/errors.py``; the
port's runtime raises these names.
"""
from __future__ import annotations


class RegistrationClosed(RuntimeError):
    """Raised when communicators/collectives are added after first launch."""


class DeadlockTimeout(RuntimeError):
    """The daemon made no forward progress across repeated relaunches.

    Attributes
    ----------
    flight_record : dict | None
        The on-device flight-recorder export (``runtime.stats()
        ["flight_recorder"]`` schema) captured at timeout.
    diagnosis : repro_torch.core.recorder.Diagnosis | None
        Host-side analysis naming the rank + collective holding each
        stalled chain.
    """

    def __init__(self, message: str, flight_record=None, diagnosis=None):
        super().__init__(message)
        self.flight_record = flight_record
        self.diagnosis = diagnosis


class EvictionError(RuntimeError):
    """``evict(rank)`` could not rebuild a registration at R-1."""


class ConnDepthWarning(UserWarning):
    """conn_depth is too shallow for the configured burst width."""


class StepTimeout(RuntimeError):
    """A training step exceeded the fault-tolerance watchdog deadline."""
