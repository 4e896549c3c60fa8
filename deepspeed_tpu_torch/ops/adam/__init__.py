from .cpu_adam import DeepSpeedCPUAdam, cpu_adam_step_plain  # noqa: F401
