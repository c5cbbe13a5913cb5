"""Weight interop of the port: the JAX package's flax variables into the
port's models (``jax_weights``), and the torch reference's checkpoints in
both directions (``torch_weights``: reference -> port; ``export_torch``:
port -> reference, with ``reference_state_dict`` needing no reference
code). ``reference_loader`` imports the reference's model files."""
from ndtpu_torch.interop.export_torch import (  # noqa: F401
    export_backbone,
    export_ndtnet_classification,
    export_ndtnet_segmentation,
    export_ndtnetpp_classification,
    export_ndtnetpp_segmentation,
    export_pointnet_classification,
    export_pointnet_segmentation,
    export_reference,
    export_residual_connection,
    export_tnet,
    reference_state_dict,
)
from ndtpu_torch.interop.jax_weights import (  # noqa: F401
    load_jax_train_state,
    load_jax_variables,
)
from ndtpu_torch.interop.torch_weights import (  # noqa: F401
    load_reference_state,
    map_backbone,
    map_ndtnet_classification,
    map_ndtnet_segmentation,
    map_ndtnetpp_classification,
    map_ndtnetpp_segmentation,
    map_pointnet_classification,
    map_pointnet_segmentation,
    map_residual_connection,
    map_tnet,
)
