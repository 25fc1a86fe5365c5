from .math import Bbox, perspective, look_at, pmat
