"""Embedded Penn-tagged training corpus for the bundled HMM PoS model.

The reference ships pre-trained OpenNLP/ClearTK tagger models as binary
artifacts; with no egress, the equivalent here is a hand-tagged seed corpus
(coarse Penn treebank tags) embedded in-package. It deliberately covers
tag-ambiguous words in disambiguating contexts — "can" (MD vs NN), "book"
(NN vs VB), "plants" (NNS vs VBZ), "walks" (VBZ vs NNS) — which is exactly
what the rule lexicon in `pos.py` cannot resolve.

Regenerate the bundled model after editing:
    python -m deeplearning4j_tpu_torch.text.pos_tagged_corpus

A copy of `deeplearning4j_tpu/text/pos_tagged_corpus.py`
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

_RAW = """
the/DT dog/NN runs/VBZ in/IN the/DT park/NN
a/DT cat/NN sleeps/VBZ on/IN the/DT mat/NN
she/PRP can/MD open/VB the/DT can/NN
he/PRP will/MD book/VB a/DT room/NN
i/PRP read/VBP the/DT book/NN
the/DT plants/NNS grow/VBP quickly/RB
she/PRP plants/VBZ trees/NNS every/DT year/NN
he/PRP walks/VBZ to/IN work/NN
the/DT walks/NNS are/VBP long/JJ
they/PRP watch/VBP the/DT old/JJ movie/NN
the/DT watch/NN is/VBZ broken/JJ
we/PRP play/VBP music/NN at/IN night/NN
the/DT play/NN was/VBD good/JJ
dogs/NNS bark/VBP loudly/RB
the/DT bark/NN of/IN the/DT tree/NN is/VBZ rough/JJ
a/DT man/NN saw/VBD the/DT bird/NN
the/DT saw/NN cuts/VBZ wood/NN
she/PRP runs/VBZ fast/RB
the/DT runs/NNS were/VBD scored/VBN early/RB
birds/NNS fly/VBP south/RB in/IN winter/NN
a/DT fly/NN landed/VBD on/IN the/DT table/NN
he/PRP must/MD finish/VB the/DT work/NN
children/NNS like/VBP sweet/JJ fruit/NN
the/DT big/JJ house/NN has/VBZ small/JJ windows/NNS
old/JJ friends/NNS talked/VBD for/IN hours/NNS
the/DT train/NN arrives/VBZ at/IN noon/NN
they/PRP train/VBP new/JJ workers/NNS
a/DT light/JJ rain/NN fell/VBD slowly/RB
please/RB light/VB the/DT fire/NN
we/PRP visited/VBD a/DT beautiful/JJ city/NN
this/DT result/NN seems/VBZ very/RB strange/JJ
the/DT teacher/NN explained/VBD the/DT lesson/NN clearly/RB
students/NNS study/VBP hard/RB before/IN exams/NNS
the/DT study/NN was/VBD published/VBN yesterday/RB
wind/NN blows/VBZ from/IN the/DT north/NN
strong/JJ winds/NNS damaged/VBD the/DT roof/NN
farmers/NNS water/VBP the/DT fields/NNS daily/RB
cold/JJ water/NN flows/VBZ down/RB
i/PRP never/RB drink/VBP coffee/NN at/IN night/NN
the/DT drink/NN tastes/VBZ bitter/JJ
he/PRP quietly/RB closed/VBD the/DT heavy/JJ door/NN
the/DT close/JJ game/NN ended/VBD late/RB
they/PRP close/VBP the/DT shop/NN early/RB
five/CD birds/NNS sat/VBD on/IN two/CD wires/NNS
she/PRP bought/VBD three/CD red/JJ apples/NNS
the/DT quick/JJ brown/JJ fox/NN jumps/VBZ over/IN the/DT lazy/JJ dog/NN
a/DT good/JJ plan/NN needs/VBZ careful/JJ thought/NN
we/PRP plan/VBP to/TO travel/VB tomorrow/RB
to/TO win/VB takes/VBZ effort/NN
he/PRP wants/VBZ to/TO learn/VB quickly/RB
the/DT market/NN opens/VBZ at/IN nine/CD
new/JJ ideas/NNS change/VBP the/DT world/NN
the/DT change/NN was/VBD sudden/JJ
workers/NNS demand/VBP fair/JJ pay/NN
the/DT demand/NN for/IN food/NN grew/VBD
the/DT plants/NNS need/VBP water/NN
these/DT plants/NNS bloom/VBP in/IN spring/NN
the/DT trees/NNS lose/VBP leaves/NNS in/IN autumn/NN
tall/JJ trees/NNS shade/VBP the/DT garden/NN
he/PRP waters/VBZ the/DT plants/NNS
she/PRP grows/VBZ tomatoes/NNS
farmers/NNS plant/VBP seeds/NNS in/IN rows/NNS
the/DT workers/NNS build/VBP houses/NNS
many/JJ students/NNS ask/VBP questions/NNS
the/DT children/NNS eat/VBP apples/NNS
some/DT people/NNS prefer/VBP tea/NN
the/DT cats/NNS chase/VBP mice/NNS
several/JJ dogs/NNS play/VBP outside/RB
many/JJ birds/NNS sing/VBP sweetly/RB
the/DT creation/NN of/IN new/JJ tools/NNS takes/VBZ time/NN
a/DT collection/NN of/IN old/JJ coins/NNS sold/VBD well/RB
few/JJ people/NNS know/VBP the/DT answer/NN
"""


def tagged_sentences():
    """[(word, tag), ...] per sentence, parsed from the embedded corpus."""
    out = []
    for line in _RAW.strip().splitlines():
        pairs = []
        for tok in line.split():
            if "/" not in tok:
                continue
            w, t = tok.rsplit("/", 1)
            pairs.append((w, t))
        if pairs:
            out.append(pairs)
    return out


def main() -> None:
    import os

    from deeplearning4j_tpu_torch.text.hmm_pos import (_BUNDLED,
                                                       HmmPosTagger)

    # light smoothing: the seed corpus is small, so heavier smoothing
    # drowns genuine counts (NNS/VBP contexts) in uniform mass; training
    # counts on the host, so no card is needed
    tagger = HmmPosTagger(device="cpu").train(tagged_sentences(),
                                              smoothing=0.2)
    os.makedirs(os.path.dirname(_BUNDLED), exist_ok=True)
    tagger.save(_BUNDLED)
    print(f"saved {_BUNDLED} ({len(tagger.tags)} tags, "
          f"{len(tagger.log_emit)} words)")


if __name__ == "__main__":
    main()
