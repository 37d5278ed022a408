"""Workloads: `Task` and its registry (importing registers the zoo)."""
from repro_torch.tasks.base import (
    Task,
    as_task,
    get_task,
    is_task,
    list_tasks,
    loss_of,
    opt_width,
    register_task,
)

# importing the module registers the built-in tasks
from repro_torch.tasks import zoo  # noqa: F401

__all__ = [
    "Task",
    "as_task",
    "get_task",
    "is_task",
    "list_tasks",
    "loss_of",
    "opt_width",
    "register_task",
    "zoo",
]
