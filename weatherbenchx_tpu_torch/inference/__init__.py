"""Statistical inference on aggregated states: the port of
``weatherbenchx_tpu/inference``."""

from weatherbenchx_tpu_torch.inference import autodiff
from weatherbenchx_tpu_torch.inference import base
from weatherbenchx_tpu_torch.inference import baseline_comparison
from weatherbenchx_tpu_torch.inference import bootstrap
from weatherbenchx_tpu_torch.inference import t_test
from weatherbenchx_tpu_torch.inference import utils
