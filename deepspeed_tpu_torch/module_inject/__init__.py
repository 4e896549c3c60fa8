from .replace_module import (load_checkpoint_dir,  # noqa: F401
                             replace_transformer_layer,
                             revert_transformer_layer)
from .replace_policy import (HFGPT2LayerPolicy,  # noqa: F401
                             HFLlamaLayerPolicy, generic_policies,
                             match_policy)
