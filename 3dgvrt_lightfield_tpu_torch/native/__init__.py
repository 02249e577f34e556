"""Native C++ components (the fast PLY reader; built with g++ at first use)."""

from . import ply_native
