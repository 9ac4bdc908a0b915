"""Wrappers of the hand-written CUDA kernels (sources in ``csrc/``).

Each module holds one kernel's wrappers, their plain PyTorch versions
and a ``launches`` counter per entry (a frame-batched entry counts on
its own, ``launches_batched``). A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel (adding one to
its counter) or raises. There is no other switch between the two.
``blur_dog_thin`` is K5's one launch for all levels of the thin octaves.
``extrema_mask_octaves`` and ``orientation_hist_octaves`` are K1's and
K3's launches over all octaves of a frame or batch; ``extrema_mask``,
``extrema_mask_batched`` and ``orientation_hist`` the same kernels on one
octave.
``descriptor_loop_octaves`` is K4's launch over all octaves of a frame or
batch, ``descriptor_loop`` the same kernel on one octave.
``compact`` is the compaction of all octaves' masks (one launch a call)
and ``refine_octaves`` K2's launch over the rows of all octaves and
frames; ``refine`` and ``refine_batched`` the same kernel on one octave,
off every extraction path. The bucketed
entries of K3 and K4 add no kernel of their own: each counts the
calls in which it launched the kernel beneath it. ``refine_octaves_bounded``,
``orientation_hist_octaves_bounded`` and ``descriptor_loop_octaves_bounded``
count the launches over all octaves that carry row bounds (a row band of
``parallel/spatial.py``); the same calls without bounds count in the
unbounded entries.
"""

from . import (blur_chain, blur_dog, compact, desc, extrema_mask, orient,
               refine, window)

# entry name -> (module, counter attribute, file:line of the TPU kernel)
ENTRIES = {
    blur_dog.NAME: (blur_dog, "launches", blur_dog.REPLACES),
    blur_dog.NAME_THIN: (blur_dog, "launches_thin", blur_dog.REPLACES_THIN),
    extrema_mask.NAME: (extrema_mask, "launches", extrema_mask.REPLACES),
    extrema_mask.NAME_OCTAVES: (extrema_mask, "launches_octaves",
                                extrema_mask.REPLACES_OCTAVES),
    refine.NAME: (refine, "launches", refine.REPLACES),
    refine.NAME_OCTAVES: (refine, "launches_octaves",
                          refine.REPLACES_OCTAVES),
    compact.NAME: (compact, "launches", compact.REPLACES),
    orient.NAME: (orient, "launches", orient.REPLACES),
    orient.NAME_OCTAVES: (orient, "launches_octaves",
                          orient.REPLACES_OCTAVES),
    desc.NAME: (desc, "launches", desc.REPLACES),
    desc.NAME_OCTAVES: (desc, "launches_octaves", desc.REPLACES_OCTAVES),
    extrema_mask.NAME_BATCHED: (extrema_mask, "launches_batched",
                                extrema_mask.REPLACES_BATCHED),
    refine.NAME_BATCHED: (refine, "launches_batched",
                          refine.REPLACES_BATCHED),
    window.NAME: (window, "launches", window.REPLACES),
    window.NAME_BATCHED: (window, "launches_batched",
                          window.REPLACES_BATCHED),
    blur_chain.NAME: (blur_chain, "launches", blur_chain.REPLACES),
    desc.NAME_PATCHES: (desc, "launches_patches", desc.REPLACES_PATCHES),
    orient.NAME_BUCKETED: (orient, "launches_bucketed",
                           orient.REPLACES_BUCKETED),
    desc.NAME_BUCKETED: (desc, "launches_bucketed", desc.REPLACES_BUCKETED),
    refine.NAME_OCTAVES_BOUNDED: (refine, "launches_octaves_bounded",
                                  refine.REPLACES_OCTAVES_BOUNDED),
    orient.NAME_OCTAVES_BOUNDED: (orient, "launches_octaves_bounded",
                                  orient.REPLACES_OCTAVES_BOUNDED),
    desc.NAME_OCTAVES_BOUNDED: (desc, "launches_octaves_bounded",
                                desc.REPLACES_OCTAVES_BOUNDED),
}


def reset_launch_counts() -> None:
    for mod, attr, _ in ENTRIES.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr, _) in ENTRIES.items()}
