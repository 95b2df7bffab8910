#!/bin/sh
# 2-D validated dam break (Koshizuka & Oka 1996), the reference's headline
# example (examples/main/01_DamBreak), on the PyTorch/CUDA port: the twin of
# examples/01_dambreak.sh, whose SHIPPED case XML it runs (the path is read
# from that script).  Runs on the card (cuda:0) through the port's CLI;
# --cpu runs it on the CPU instead.  Further arguments go to the CLI after
# these ones, so a later -case or -dirout takes their place.  $PYTHON names
# the interpreter (python by default).
here=$(dirname "$0")
casexml=$(sed -n 's/^ *-case \([^ ]*\).*/\1/p' "$here/../01_dambreak.sh")
for a do
    shift
    if [ "$a" = "--cpu" ]; then
        set -- "$@" -cpu
    else
        set -- "$@" "$a"
    fi
done
exec "${PYTHON:-python}" -m dualsphysics_multilayer_tpu_torch.cli \
    -case "$casexml" -dirout out_dambreak -sv:binx,vtk -svres "$@"
