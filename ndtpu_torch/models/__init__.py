"""Model families of the port (channels-last [B, N, C], ``Dense`` layers for
the reference's pointwise convolutions)."""
from ndtpu_torch.models.dense import Dense  # noqa: F401
from ndtpu_torch.models.ndtnet import (  # noqa: F401
    AdditionalFeatures,
    NDTNet,
    NDTNetClassification,
    NDTNetSegmentation,
)
from ndtpu_torch.models.ndtnetpp import (  # noqa: F401
    NDTNetPP,
    NDTNetPPClassification,
    NDTNetPPSegmentation,
    ResidualConnection,
)
from ndtpu_torch.models.pointnet import (  # noqa: F401
    PointNet,
    PointNetClassification,
    PointNetSegmentation,
)
from ndtpu_torch.models.tnet import TNet  # noqa: F401
