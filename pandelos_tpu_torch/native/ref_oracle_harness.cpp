// Non-JNI harness around the REFERENCE'S OWN compiled kernel.
//
// Every golden in this repo descends from a Python transcription of
// the reference (reference.py); both sides of every differential test
// encode that transcription's READING of ig/native/library.cpp.  This
// harness closes that authorship circle: it #includes the reference's
// library.cpp translation unit UNMODIFIED (read-only, from the tree
// named by PANDELOS_REF_ROOT — path injected at compile time as
// REF_LIBRARY_CPP)
// and drives its real entry points:
//
//   - Java_..._preprocessSequences (library.cpp:189-371) runs against a
//     ~100-line mock JNIEnv whose function table serves the .faa data —
//     the reference's own census / rank_init / do_ranking / radix sort /
//     dedup / posting-range build executes verbatim;
//   - the internal computeScores(info, sequences, step)
//     (library.cpp:409-527) is called directly per genome (it takes
//     plain vectors; only its JNI marshalling wrapper is skipped).
//
// Output: one line per nonzero score cell "x y <score> <perc> <tr_perc>"
// with the three f32 values dumped as raw hex bits, for bit-exact
// comparison against net.finalize_scores.
//
// Build/run: native/ref_oracle.py (g++ -O2, vendored JNI headers from
// the reference tree).  No reference code is copied into this repo.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

// The reference translation unit (defines the JNI entry points, the
// internal computeScores, and the global pair_info).
#include REF_LIBRARY_CPP

// ---------------------------------------------------------------------
// Mock JNI surface: just enough of JNINativeInterface_ for the
// preprocessSequences reflection calls.  Handles are tagged integers.
// ---------------------------------------------------------------------

static std::vector<std::vector<jchar>> g_seqs;  // UTF-16ified residues
static std::vector<int> g_gens;                 // genome id per sequence

static const intptr_t H_DATA = 1, H_SEQ_VEC = 2, H_GEN_VEC = 3;
static const intptr_t F_SEQUENCES = 1, F_SEQ_GENOME = 2;
static const intptr_t M_GET = 1, M_SIZE = 2, M_INTVALUE = 3;
static const intptr_t INT_BASE = 1 << 20;   // Integer handles
static const intptr_t STR_BASE = 1 << 24;   // String handles

static jclass mock_GetObjectClass(JNIEnv *, jobject obj) {
    return (jclass)obj;  // class handle == object handle (tag only)
}

static jfieldID mock_GetFieldID(JNIEnv *, jclass, const char *name,
                                const char *) {
    if (!strcmp(name, "sequences")) return (jfieldID)F_SEQUENCES;
    if (!strcmp(name, "sequenceGenome")) return (jfieldID)F_SEQ_GENOME;
    return (jfieldID)0;
}

static jobject mock_GetObjectField(JNIEnv *, jobject, jfieldID fid) {
    return (jobject)((intptr_t)fid == F_SEQUENCES ? H_SEQ_VEC : H_GEN_VEC);
}

static jmethodID mock_GetMethodID(JNIEnv *, jclass, const char *name,
                                  const char *) {
    if (!strcmp(name, "get")) return (jmethodID)M_GET;
    if (!strcmp(name, "size")) return (jmethodID)M_SIZE;
    if (!strcmp(name, "intValue")) return (jmethodID)M_INTVALUE;
    return (jmethodID)0;
}

static jint JNICALL mock_CallIntMethodV(JNIEnv *, jobject obj,
                                        jmethodID mid, va_list) {
    if ((intptr_t)mid == M_SIZE) return (jint)g_seqs.size();
    if ((intptr_t)mid == M_INTVALUE)
        return (jint)((intptr_t)obj - INT_BASE);  // Integer handle
    return 0;
}

static jobject JNICALL mock_CallObjectMethodV(JNIEnv *, jobject obj,
                                              jmethodID mid, va_list args) {
    if ((intptr_t)mid != M_GET) return nullptr;
    jint i = va_arg(args, jint);
    if ((intptr_t)obj == H_SEQ_VEC) return (jobject)(STR_BASE + i);
    return (jobject)(INT_BASE + g_gens[i]);  // boxed-Integer handle
}

static jsize mock_GetStringLength(JNIEnv *, jstring str) {
    return (jsize)g_seqs[(intptr_t)str - STR_BASE].size();
}

static const jchar *mock_GetStringChars(JNIEnv *, jstring str,
                                        jboolean *isCopy) {
    if (isCopy) *isCopy = JNI_FALSE;
    return g_seqs[(intptr_t)str - STR_BASE].data();
}

static void mock_ReleaseStringChars(JNIEnv *, jstring, const jchar *) {}

int main(int argc, char **argv) {
    if (argc < 4) {
        fprintf(stderr, "usage: %s <input.faa> <k> <out.cells>\n", argv[0]);
        return 2;
    }
    const char *faa_path = argv[1];
    int k = atoi(argv[2]);
    const char *out_path = argv[3];

    // .faa: alternating "genome\tgene\tproduct" header and sequence
    // lines; genome ids by first appearance (PangeneIData.java:57-62)
    std::ifstream in(faa_path);
    if (!in) { fprintf(stderr, "cannot read %s\n", faa_path); return 2; }
    std::map<std::string, int> genome_ids;
    std::string header, seq;
    while (std::getline(in, header)) {
        if (header.empty()) continue;
        if (!std::getline(in, seq)) break;
        std::string genome = header.substr(0, header.find('\t'));
        auto it = genome_ids.find(genome);
        int gid;
        if (it == genome_ids.end()) {
            gid = (int)genome_ids.size();
            genome_ids.emplace(genome, gid);
        } else {
            gid = it->second;
        }
        std::vector<jchar> chars(seq.size());
        for (size_t i = 0; i < seq.size(); i++)
            chars[i] = (jchar)(unsigned char)seq[i];
        g_seqs.push_back(std::move(chars));
        g_gens.push_back(gid);
    }

    JNINativeInterface_ table;
    memset(&table, 0, sizeof(table));
    table.GetObjectClass = mock_GetObjectClass;
    table.GetFieldID = mock_GetFieldID;
    table.GetObjectField = mock_GetObjectField;
    table.GetMethodID = mock_GetMethodID;
    table.CallIntMethodV = mock_CallIntMethodV;
    table.CallObjectMethodV = mock_CallObjectMethodV;
    table.GetStringLength = mock_GetStringLength;
    table.GetStringChars = mock_GetStringChars;
    table.ReleaseStringChars = mock_ReleaseStringChars;
    JNIEnv_ env;
    env.functions = &table;

    // the reference's own index build (census, rank_init, do_ranking,
    // radix sort, dedup, posting ranges)
    Java_infoasys_cli_pangenes_PangeneNative_preprocessSequences(
        &env, nullptr, (jobject)H_DATA, (jint)k, JNI_FALSE);

    // the reference's own scoring kernel, per genome, hex-bit dump
    FILE *out = fopen(out_path, "w");
    if (!out) { fprintf(stderr, "cannot write %s\n", out_path); return 2; }
    for (unsigned int g = 0; g < global_info.genomes_count; g++) {
        scores sc = computeScores(
            global_info, global_info.genome_sequences[g], 2048);
        for (auto const &c : sc.non_zero) {
            uint32_t sb, pb, tb;
            memcpy(&sb, &c.score, 4);
            memcpy(&pb, &c.perc, 4);
            memcpy(&tb, &c.tr_perc, 4);
            fprintf(out, "%u %u %08x %08x %08x\n", c.x, c.y, sb, pb, tb);
        }
    }
    fclose(out);
    return 0;
}
