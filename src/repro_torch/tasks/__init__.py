"""Workloads: `Task` and its registry (importing registers the zoo)."""
from repro_torch.tasks.base import Task, get_task, is_task, list_tasks, register_task
from repro_torch.tasks import zoo  # noqa: F401  (registers the built-in tasks)

__all__ = ["Task", "get_task", "is_task", "list_tasks", "register_task"]
