"""Run bookkeeping on the host: Run.csv and the TERMINATE file
(``runinfo``), Run.out (``log``), named timers (``timers``) and the PIPS
pair counts (``pips``)."""
