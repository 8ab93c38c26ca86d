"""System-wide enums and constants.

The port's own copy of ``rafiki_tpu/constants.py`` (``StrEnum``,
``BudgetOption``, ``TrainJobStatus``, ``SubTrainJobStatus``,
``TrialStatus``, ``InferenceJobStatus``, ``ServiceType``,
``ServiceStatus``, ``UserType``, ``TaskType``, ``ModelAccessRight``,
``ModelDependencyManagedBy``), with the same string values, so rows one
package writes to a meta store the other reads. String-valued enums so
they serialize cleanly through JSON and SQLite.
"""

from __future__ import annotations

import enum


class StrEnum(str, enum.Enum):
    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


class BudgetOption(StrEnum):
    """Budget knobs accepted by ``create_train_job``."""

    TRIAL_COUNT = "TRIAL_COUNT"
    TIME_HOURS = "TIME_HOURS"
    # the unit is a device slot (one or more CUDA cards)
    WORKER_COUNT = "WORKER_COUNT"
    # Accepted alias for reference compatibility.
    GPU_COUNT = "GPU_COUNT"


class TrainJobStatus(StrEnum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class SubTrainJobStatus(StrEnum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class TrialStatus(StrEnum):
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ERRORED = "ERRORED"
    TERMINATED = "TERMINATED"  # killed early (e.g. BOHB rung cut / preemption)


class InferenceJobStatus(StrEnum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"


class ServiceType(StrEnum):
    ADVISOR = "ADVISOR"
    TRAIN_WORKER = "TRAIN_WORKER"
    INFERENCE_WORKER = "INFERENCE_WORKER"
    PREDICTOR = "PREDICTOR"
    DATA_PLANE = "DATA_PLANE"  # native kv/queue server (Redis stand-in)


class ServiceStatus(StrEnum):
    STARTED = "STARTED"
    RUNNING = "RUNNING"
    STOPPED = "STOPPED"
    ERRORED = "ERRORED"
    # verdict of the boot reconciler: the row's recorded process did not
    # survive the admin's death (pid gone, identity mismatch, or failed
    # health probe). Terminal like ERRORED; crashed WORKERS of a still-
    # RUNNING job flow into the respawn path.
    CRASHED = "CRASHED"


class UserType(StrEnum):
    SUPERADMIN = "SUPERADMIN"
    ADMIN = "ADMIN"
    MODEL_DEVELOPER = "MODEL_DEVELOPER"
    APP_DEVELOPER = "APP_DEVELOPER"


class TaskType(StrEnum):
    """Well-known task names; model templates declare which they serve."""

    IMAGE_CLASSIFICATION = "IMAGE_CLASSIFICATION"
    TEXT_CLASSIFICATION = "TEXT_CLASSIFICATION"
    POS_TAGGING = "POS_TAGGING"
    TABULAR_CLASSIFICATION = "TABULAR_CLASSIFICATION"
    TABULAR_REGRESSION = "TABULAR_REGRESSION"
    LANGUAGE_MODELING = "LANGUAGE_MODELING"


class ModelAccessRight(StrEnum):
    PUBLIC = "PUBLIC"
    PRIVATE = "PRIVATE"


class ModelDependencyManagedBy(StrEnum):
    """Reference installs pip deps per model container; here deps must be
    preinstalled (no egress), so this only records intent."""

    REQUESTED = "REQUESTED"
    PREINSTALLED = "PREINSTALLED"
