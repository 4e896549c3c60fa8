from .cpu_adagrad import (DeepSpeedCPUAdagrad,  # noqa: F401
                          cpu_adagrad_step_plain)
