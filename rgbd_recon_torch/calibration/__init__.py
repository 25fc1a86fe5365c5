from .volume import CalibrationVolume
from .rig import RigCalibration, build_rig
from .frustum import Frustum
