from . import pixel
