"""OCCL core, PyTorch port: the deadlock-free collective execution framework.

Collectives are per-rank primitive sequences over connector ring buffers,
executed by a daemon loop of supersteps with decentralized preemption
(spin thresholds) and stickiness-driven gang scheduling.  This package is
the sim backend — all ranks on one device — of ``repro.core``; see
ROADMAP.md for what is still to be ported.
"""
from .algos import (AUTO_CANDIDATES, PLAN_BUILDERS, CompositePlan,
                    SubCollective, build_plan, default_hierarchy,
                    plan_hybrid, plan_torus, plan_tree_broadcast,
                    plan_tree_reduce, plan_two_level,
                    plan_two_level_alltoall, register_plan, select_algo)
from .config import OcclConfig, OrderPolicy, ReduceOp
from .costmodel import CostModel, fit, plan_features
from .daemon import TickFlags, build_sim_tick, launch_prologue
from .deadlock import consistent_order_exists, run_static_order
from .errors import (ConnDepthWarning, DeadlockTimeout, EvictionError,
                     RegistrationClosed, StepTimeout)
from .handles import CollectiveHandle
from .primitives import CollKind, CollectiveSpec, Communicator, Prim
from .recorder import (EVENT_NAMES, Diagnosis, FlightEvent, StalledChain,
                       diagnose, events)
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
    "FlightEvent", "StalledChain", "Diagnosis", "EVENT_NAMES",
    "events", "diagnose",
    "TickFlags", "launch_prologue", "build_sim_tick",
    "DaemonState", "init_state", "state_from_numpy", "state_to_numpy",
    "tables_from_numpy",
    "run_static_order", "consistent_order_exists",
    "CompositePlan", "SubCollective", "default_hierarchy",
    "plan_two_level", "plan_torus", "plan_hybrid",
    "plan_tree_broadcast", "plan_tree_reduce", "plan_two_level_alltoall",
    "PLAN_BUILDERS", "AUTO_CANDIDATES", "register_plan", "build_plan",
    "select_algo", "CostModel", "plan_features", "fit",
]
