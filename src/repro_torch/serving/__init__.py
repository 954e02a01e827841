"""Serving on the port: the continuous-batching engine
(:mod:`repro_torch.serving.engine`) and the QoS fabric that shares one OCCL
runtime among traffic classes (:mod:`repro_torch.serving.qos`)."""
from .engine import Request, ServingEngine
from .qos import (AGING_CAP, CLASS_STRIDE, ServingQos, TenantStats,
                  TrafficClass, class_prio)

__all__ = ["AGING_CAP", "CLASS_STRIDE", "Request", "ServingEngine",
           "ServingQos", "TenantStats", "TrafficClass", "class_prio"]
