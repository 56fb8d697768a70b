"""Small sizes of each cell, for runs of the harness on the CPU (the
correctness tests): the same traffic, configuration and comparison at a
size a test run holds.

Readings differ with size (bfloat16 rounds coordinates by their
magnitude; the small stitch tiles overlap over fewer pixels), so the
comparison is held here to limits set as the cells' own are (PERF.md),
from readings at these sizes (``control.py --tiny``, CPU, four seeds
each): sound runs / the control, worst and best:
  align.match    match_err_p95_px 2.00 / 6.44      -> 3.6
  stitch.section match_err_p95_px 1.41 / 3.07      -> 2.0
                 place_err_px     0.075 / 1.02     -> 0.7
                 render_err_lsb   0.72 / 33.6      -> 8.0
                 render_err_local_lsb 1.79 / 37.5  -> 8.0
The small stack's warp is 6 px a section step (the cell's: 2 px); a
matcher left at its global seed reads above the limit here (8.1 px) as at
the cell's own size (PERF.md).
"""

LIMITS = {
    'align.match': {'match_err_p95_px': 3.6},
    'stitch.section': {'match_err_p95_px': 2.0, 'place_err_px': 0.7,
                       'render_err_lsb': 8.0, 'render_err_local_lsb': 8.0},
}


def shrink(cell, workload, config):
    d = config['deployment']
    if 'section' in d:
        d.update(section=2048, tile=1024, margin=64, drift_std=6.0, warp_amp=6.0,
                 warp_period=512.0, texture_blur=4.0)
        workload['params']['pool'] = min(workload['params']['pool'], 3)
        over = config['overrides']['alignment_configs.yaml']
        over['meshing']['mesh_size'] = 200
        config['files']['default_alignment_configs.yaml']['meshing']['mesh_size'] = 200
        over['matching']['working_mip_level'] = 1
        if 'reference' in workload:
            workload['reference'].update(pitch_px=32, margin_px=64, near_px=50)
    else:
        d.update(tile_h=750, tile_w=1000, overlap_y=75, overlap_x=100, margin=20)
        # corner overlaps of 100 x 75 px are too small to match reliably
        workload['reference']['min_overlap_px'] = 80
    workload['limits'] = dict(LIMITS[cell])
    return workload, config
