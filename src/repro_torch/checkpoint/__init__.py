from .checkpoint import (load_arrays, load_extra, load_step, restore,
                         save)
