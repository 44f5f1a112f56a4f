"""The benchmark of ``video_stabilization_tpu_torch`` on NVIDIA cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything that
belongs to one configuration, traffic mix, cell or metric is a file of its
own that the harness finds by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``workloads/<cell>.json`` (which names its
driver, ``drivers/<driver>.py``) and ``metrics/<metric>.py``.
``reference/`` is the plain pipeline that decides ``correct``;
``traffic/sim.py`` the frozen footage generator.
"""
