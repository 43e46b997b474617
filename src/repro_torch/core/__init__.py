# Verbatim copy of repro/core/__init__.py (the JAX package's original); only import paths may differ.
"""Harpagon's core: dispatching, scheduling and latency splitting (the paper)."""
from .dag import AppDAG, Leaf, Par, Series, Workload, par, series
from .dispatch import Alloc, Policy, config_wcl, module_wcl, total_cost
from .harpagon import Plan, Planner, PlannerOptions, plan
from .profiles import Config, Hardware, ModuleProfile, TABLE1
from .residual import ModuleSchedule, schedule_module
from .scheduler import generate_config, generate_config_ktuple

__all__ = [
    "AppDAG",
    "Alloc",
    "Config",
    "Hardware",
    "Leaf",
    "ModuleProfile",
    "ModuleSchedule",
    "Par",
    "Plan",
    "Planner",
    "PlannerOptions",
    "Policy",
    "Series",
    "TABLE1",
    "Workload",
    "config_wcl",
    "generate_config",
    "generate_config_ktuple",
    "module_wcl",
    "par",
    "plan",
    "schedule_module",
    "series",
    "total_cost",
]
