from .base import Reconstruction, ReconContext
from .points import ReconPoints
from .integration import ReconIntegration
from .trigrid import ReconTrigrid
from .mvt import ReconMVT
from .calibs import ReconCalibs
