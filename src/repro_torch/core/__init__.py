"""OCCL core, PyTorch port: the deadlock-free collective execution framework.

Collectives are per-rank primitive sequences over connector ring buffers,
executed by a daemon loop of supersteps with decentralized preemption
(spin thresholds) and stickiness-driven gang scheduling.  This package is
the sim backend — all ranks on one device — of ``repro.core``; see
ROADMAP.md for what is still to be ported.
"""
from .algos import select_algo
from .config import OcclConfig, OrderPolicy, ReduceOp
from .daemon import TickFlags, build_sim_tick, launch_prologue
from .deadlock import consistent_order_exists, run_static_order
from .errors import (ConnDepthWarning, DeadlockTimeout, EvictionError,
                     RegistrationClosed, StepTimeout)
from .handles import CollectiveHandle
from .primitives import CollKind, CollectiveSpec, Communicator, Prim
from .recorder import EVENT_NAMES, FlightEvent, events
from .runtime import OcclRuntime
from .staging import StagingEngine
from .state import (DaemonState, init_state, state_from_numpy,
                    state_to_numpy, tables_from_numpy)

__all__ = [
    "OcclConfig", "OrderPolicy", "ReduceOp",
    "CollKind", "CollectiveSpec", "Communicator", "Prim",
    "OcclRuntime", "DeadlockTimeout", "ConnDepthWarning", "StagingEngine",
    "EvictionError", "RegistrationClosed", "StepTimeout",
    "CollectiveHandle",
    "FlightEvent", "EVENT_NAMES", "events",
    "TickFlags", "launch_prologue", "build_sim_tick",
    "DaemonState", "init_state", "state_from_numpy", "state_to_numpy",
    "tables_from_numpy",
    "run_static_order", "consistent_order_exists", "select_algo",
]
