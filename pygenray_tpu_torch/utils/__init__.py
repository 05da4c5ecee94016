from . import xrlite
