"""Serving on the port: the QoS fabric that shares one OCCL runtime among
traffic classes (:mod:`repro_torch.serving.qos`)."""
from .qos import (AGING_CAP, CLASS_STRIDE, ServingQos, TenantStats,
                  TrafficClass, class_prio)

__all__ = ["AGING_CAP", "CLASS_STRIDE", "ServingQos", "TenantStats",
           "TrafficClass", "class_prio"]
