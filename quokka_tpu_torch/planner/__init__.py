"""Runtime re-optimisation (port of ``quokka_tpu/planner/``): the adaptive
exchange (``adapt.py``) and its plan-time eligibility pass (``decide.py``).
The reference's cost model and cost-fed passes come with a later slice."""
