"""Multi-host task distribution and the dp×tp train step."""

from .dist import get_task_list, init_pod, local_rank  # noqa: F401
